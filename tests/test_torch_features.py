"""The port's whitening (``Whitener``) and feature extraction
(``spatial_pyramid_pool``, ``FeatureExtractor``) against lyssandra_tpu and
its numpy oracle on the CPU, the same float32 inputs from a numpy seed.

Tolerances: ZCA matrices and whitened data within 1e-4 of the largest
entry (two float32 eigensolvers); PCA rows the same up to each component's
sign; pooling exact (a max); features over an orthonormal DCT (K=64)
within 1e-4, over the overcomplete K=256 DCT on >= 99% of entries (OMP
near-ties follow rounding); a colour ``transform_image`` over a unit-norm
Gaussian (192, 64) dictionary within 1e-4 of the largest feature; the
fused patch pipeline's plain version with ``fused_params`` within 1e-4 of
``transform`` of the extracted patches."""

import dataclasses

import numpy as np
import pytest
import torch

from lyssandra_tpu import oracle
from lyssandra_tpu.apps.features import FeatureExtractor as JFeatureExtractor
from lyssandra_tpu.apps.features import (
    spatial_pyramid_pool as j_spatial_pyramid_pool,
)
from lyssandra_tpu.config import WhitenConfig as JWhitenConfig
from lyssandra_tpu.ops import dct_dictionary as j_dct_dictionary
from lyssandra_tpu.ops.whitening import Whitener as JWhitener
import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.apps import FeatureExtractor, spatial_pyramid_pool
from lyssandra_tpu_torch.ops import (
    contrast_normalize,
    extract_patches,
    remove_dc,
)
from lyssandra_tpu_torch.ops.cuda_patches import (
    fused_patch_pipeline,
    fused_patch_pipeline_reference,
)
from lyssandra_tpu_torch.ops.whitening import Whitener, ZCAWhitener
from lyssandra_tpu_torch.utils.interop import whitener_from_reference

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def patches():
    """8x8 patches of smooth and textured images, DC removed and
    contrast-normalized (config 6's whitener input, at a small size)."""
    imgs = [lt.utils.synthetic_image(k, 48, seed=s) for s, k in
            enumerate(("smooth", "texture", "edges", "mix"))]
    X = np.concatenate([extract_patches(_t(im), 8, 2).numpy()
                        for im in imgs], axis=1)
    X = X - X.mean(axis=0)
    X /= np.maximum(np.linalg.norm(X, axis=0), 1e-8)
    return X.astype(np.float32)


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())


def test_zca_matches_jax_and_oracle(patches):
    X = patches
    wh = Whitener(device="cpu").fit(X)
    jw = JWhitener().fit(X)
    ow = oracle.ZCAWhitener().fit(X.astype(np.float64))
    assert ZCAWhitener is Whitener
    for ref in (jw, ow):
        _close(wh.mean_.numpy(), np.asarray(ref.mean_))
        _close(wh.W_.numpy(), np.asarray(ref.W_))
        _close(wh.Winv_.numpy(), np.asarray(ref.Winv_))
    Y = wh.transform(X)
    _close(Y.numpy(), np.asarray(jw.transform(X)))
    _close(Y.numpy(), ow.transform(X.astype(np.float64)))
    # whitened: the covariance's eigenvalues are lam / (lam + eps)
    C = np.cov(Y.numpy().astype(np.float64), bias=True)
    lam = np.linalg.eigvalsh(np.cov(X.astype(np.float64), bias=True))
    np.testing.assert_allclose(np.linalg.eigvalsh(C), lam / (lam + 1e-2),
                               atol=1e-4)


def test_pca_whitening_up_to_sign(patches):
    X = patches
    cfg = lt.WhitenConfig(pca_dim=8)
    wh = Whitener(cfg, device="cpu").fit(X)
    jw = JWhitener(JWhitenConfig(pca_dim=8)).fit(X)
    W, Wj = wh.W_.numpy(), np.asarray(jw.W_)
    assert W.shape == (8, 64)
    sign = np.sign((W * Wj).sum(axis=1))
    assert (sign != 0).all()
    _close(W * sign[:, None], Wj)
    _close(wh.Winv_.numpy() * sign[None, :], np.asarray(jw.Winv_))
    _close(wh.transform(X).numpy() * sign[:, None],
           np.asarray(jw.transform(X)))
    # the round trip projects onto the 8 leading components
    R = wh.inverse_transform(wh.transform(X)).numpy()
    _close(R, np.asarray(jw.inverse_transform(jw.transform(X))))


def test_inverse_transform_and_fused_params(patches):
    X = patches
    wh = Whitener(device="cpu").fit(X)
    _close(wh.inverse_transform(wh.transform(X)).numpy(), X)
    W, off = wh.fused_params()
    Wj, offj = JWhitener().fit(X).fused_params()
    _close(W.numpy(), np.asarray(Wj))
    _close(off.numpy(), np.asarray(offj))
    assert off.shape == (64,)
    _close((W @ _t(X) - off[:, None]).numpy(), wh.transform(X).numpy())


@pytest.mark.parametrize("do_norm", [False, True], ids=["dc", "dc+norm"])
def test_k3_plain_whitening_equals_transform(patches, do_norm):
    # the fused pipeline's whitening epilogue, fed a fitted whitener, gives
    # transform() of the plainly extracted and preprocessed patches
    wh = Whitener(device="cpu").fit(patches)
    img = _t(lt.utils.synthetic_image("texture", 40, seed=3))
    got, _, _ = fused_patch_pipeline_reference(
        img, 8, do_dc=True, do_norm=do_norm, whiten=wh.fused_params())
    X, _ = remove_dc(extract_patches(img, 8))
    if do_norm:
        X, _ = contrast_normalize(X)
    _close(got.numpy(), wh.transform(X).numpy())
    # the dispatcher takes the plain version for a CPU image
    got2, _, _ = fused_patch_pipeline(img, 8, do_dc=True, do_norm=do_norm,
                                      whiten=wh.fused_params())
    assert torch.equal(got, got2)


def test_whitener_from_reference(patches):
    X = patches
    jw = JWhitener(JWhitenConfig(eps=0.05)).fit(X)
    wh = whitener_from_reference(
        np.asarray(jw.mean_), np.asarray(jw.W_), np.asarray(jw.Winv_),
        dataclasses.asdict(jw.cfg), device="cpu")
    assert wh.cfg == lt.WhitenConfig(eps=0.05)
    _close(wh.transform(X).numpy(), np.asarray(jw.transform(X)), rel=1e-5)
    _close(wh.inverse_transform(X).numpy(),
           np.asarray(jw.inverse_transform(X)), rel=1e-5)
    with pytest.raises(TypeError):
        whitener_from_reference(np.zeros(4), np.eye(4), np.eye(4),
                                {"not_a_field": 1}, device="cpu")


@pytest.mark.parametrize("grid,levels", [((6, 7), (1, 2, 4)),
                                         ((8, 8), (1, 2)), ((5, 3), (3,))])
def test_spatial_pyramid_pool_exact(rng, grid, levels):
    K = 16
    codes = rng.standard_normal((K, grid[0] * grid[1])).astype(np.float32)
    got = spatial_pyramid_pool(_t(codes), grid, levels)
    want = np.asarray(j_spatial_pyramid_pool(codes, grid, levels))
    np.testing.assert_array_equal(got.numpy(), want)
    if levels[0] == 1:      # the level-1 cell is the global max
        np.testing.assert_array_equal(got[:K].numpy(),
                                      np.abs(codes).max(axis=1))
    batch = np.stack([codes, -2.0 * codes])
    got_b = spatial_pyramid_pool(_t(batch), grid, levels)
    np.testing.assert_array_equal(got_b[0].numpy(), want)
    np.testing.assert_array_equal(got_b[1].numpy(), 2.0 * want)


def _images(rng, n, size=24):
    return (50.0 * rng.standard_normal((n, size, size))).astype(np.float32)


@pytest.mark.parametrize("preprocess", ["dc", "dc+norm"])
def test_features_orthonormal_dct_match_jax(rng, preprocess):
    imgs = _images(rng, 5)
    D = j_dct_dictionary(8, 64)
    kw = dict(patch=8, stride=4, levels=(1, 2), preprocess=preprocess)
    got = FeatureExtractor(np.asarray(D), device="cpu", **kw).transform(imgs)
    want = np.asarray(JFeatureExtractor(D, **kw).transform(imgs))
    assert got.shape == (5, 64 * 5)
    _close(got.numpy(), want)


def test_features_k256_match_jax(rng):
    imgs = _images(rng, 6, 28)
    D = j_dct_dictionary(8, 256)
    kw = dict(patch=8, stride=4, levels=(1, 2), preprocess="dc+norm")
    got = FeatureExtractor(np.asarray(D), device="cpu",
                           **kw).transform(imgs).numpy()
    want = np.asarray(JFeatureExtractor(D, **kw).transform(imgs))
    assert got.shape == want.shape == (6, 256 * 5)
    assert np.mean(np.abs(got - want) <= 1e-4) >= 0.99


def test_features_whitened_match_jax(rng, patches):
    imgs = _images(rng, 4)
    jw = JWhitener().fit(patches)
    wh = whitener_from_reference(np.asarray(jw.mean_), np.asarray(jw.W_),
                                 np.asarray(jw.Winv_), device="cpu")
    D = j_dct_dictionary(8, 64)
    kw = dict(patch=8, stride=4, levels=(1,), preprocess="dc+norm+whiten")
    got = FeatureExtractor(np.asarray(D), whitener=wh, device="cpu",
                           **kw).transform(imgs)
    want = np.asarray(JFeatureExtractor(D, whitener=jw, **kw)
                      .transform(imgs))
    _close(got.numpy(), want)
    with pytest.raises(ValueError, match="whitener"):
        FeatureExtractor(np.asarray(D), preprocess="dc+norm+whiten",
                         device="cpu")


def test_img_block_invariance(rng):
    # blocks of 2 (the last one a single image) give the one-block
    # features within 1e-6 of the largest (products over different widths
    # round differently), and so does the reference, which pads its last
    # block
    imgs = _images(rng, 7)
    D = np.asarray(j_dct_dictionary(8, 64))
    kw = dict(patch=8, stride=4, levels=(1, 2))
    big = FeatureExtractor(D, img_block=64, device="cpu",
                           **kw).transform(imgs)
    small = FeatureExtractor(D, img_block=2, device="cpu",
                             **kw).transform(imgs)
    _close(small.numpy(), big.numpy(), rel=1e-6)
    want = np.asarray(JFeatureExtractor(D, img_block=2, **kw)
                      .transform(imgs))
    _close(small.numpy(), want)
    fe = FeatureExtractor(D, device="cpu", **kw)
    one = torch.stack([fe.transform_image(im) for im in imgs])
    _close(one.numpy(), big.numpy(), rel=1e-6)
    lists = fe.transform(list(imgs))
    np.testing.assert_array_equal(lists.numpy(), big.numpy())


@pytest.mark.parametrize("preprocess", ["dc", "dc+norm"])
def test_transform_image_colour_matches_jax(rng, preprocess):
    # an (H, W, C) image codes its channel-stacked (3 p^2, N) patches and
    # pools them on the (H, W) patch grid, as the reference's does
    img = (255.0 * rng.random((24, 24, 3))).astype(np.float32)
    D = rng.standard_normal((192, 64))
    D = (D / np.linalg.norm(D, axis=0)).astype(np.float32)
    kw = dict(patch=8, stride=4, preprocess=preprocess)
    got = FeatureExtractor(D, device="cpu", **kw).transform_image(img)
    want = np.asarray(JFeatureExtractor(D, **kw).transform_image(img))
    assert got.shape == want.shape == (64 * 21,)
    _close(got.numpy(), want)


def test_feature_extractor_encoder_and_device(rng):
    # the default encoder is Batch-OMP T=10 without the atom check; a CPU
    # dictionary keeps the images on the CPU
    D = lt.dct_dictionary(8, 64, device="cpu")
    fe = FeatureExtractor(D, levels=(1,))
    assert fe.encoder.algorithm == "bomp" and fe.encoder.params == {"T": 10}
    assert fe.encoder.check_atoms is False
    F = fe.transform(_images(rng, 2))
    assert F.device.type == "cpu" and F.shape == (2, 64)
