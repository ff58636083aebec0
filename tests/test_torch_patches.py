"""The port's patch ops, its fused-patch-pipeline plain version and its DCT
dictionary against lyssandra_tpu (same float32 inputs from a numpy seed;
the JAX side on the CPU, its Pallas kernel in interpret mode)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lyssandra_tpu.ops import dictionaries as jdict
from lyssandra_tpu.ops import patches as jpatches
from lyssandra_tpu.ops.pallas_patches import fused_patch_pipeline_p1 as jp1
from lyssandra_tpu.ops.whitening import Whitener
from lyssandra_tpu_torch.ops import cuda_patches, dictionaries, patches

torch.set_num_threads(1)

# 0-255 images in float32: atol 1e-4 is a few float32 ulps at 255
ATOL = 1e-4


def _image(rng, shape):
    return (255.0 * rng.random(shape)).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("shape", [(20, 23), (18, 21, 3)])
@pytest.mark.parametrize("stride", [1, 3])
def test_extract_fold_reconstruct_match_reference(rng, shape, stride):
    img = _image(rng, shape)
    p = 5
    X = patches.extract_patches(torch.from_numpy(img), p, stride)
    Xj = np.asarray(jpatches.extract_patches(jnp.asarray(img), p, stride))
    np.testing.assert_allclose(_np(X), Xj, atol=ATOL)
    assert patches.n_patches(*shape[:2], p, stride) == \
        jpatches.n_patches(*shape[:2], p, stride)

    # fold / reconstruct / blend a perturbed patch matrix
    Y = (Xj + rng.standard_normal(Xj.shape)).astype(np.float32)
    acc, cnt = patches.fold_patches(torch.from_numpy(Y), shape, p, stride)
    accj, cntj = jpatches.fold_patches(jnp.asarray(Y), shape, p, stride)
    np.testing.assert_allclose(_np(acc), np.asarray(accj), atol=ATOL)
    np.testing.assert_allclose(_np(cnt), np.asarray(cntj), atol=0)
    rec = patches.reconstruct_from_patches(torch.from_numpy(Y), shape, p,
                                           stride)
    recj = jpatches.reconstruct_from_patches(jnp.asarray(Y), shape, p,
                                             stride)
    np.testing.assert_allclose(_np(rec), np.asarray(recj), atol=ATOL)
    blend = patches.weighted_reconstruct(torch.from_numpy(Y),
                                         torch.from_numpy(img), p, 0.02,
                                         stride)
    blendj = jpatches.weighted_reconstruct(jnp.asarray(Y), jnp.asarray(img),
                                           p, 0.02, stride)
    np.testing.assert_allclose(_np(blend), np.asarray(blendj), atol=ATOL)


def test_remove_dc_contrast_normalize_match_reference(rng):
    X = _image(rng, (64, 300))
    Xc, m = patches.remove_dc(torch.from_numpy(X))
    Xcj, mj = jpatches.remove_dc(jnp.asarray(X))
    np.testing.assert_allclose(_np(Xc), np.asarray(Xcj), atol=ATOL)
    np.testing.assert_allclose(_np(m), np.asarray(mj), atol=ATOL)
    Xn, s = patches.contrast_normalize(Xc)
    Xnj, sj = jpatches.contrast_normalize(Xcj)
    np.testing.assert_allclose(_np(Xn), np.asarray(Xnj), atol=1e-6)
    np.testing.assert_allclose(_np(s), np.asarray(sj), rtol=1e-6)


def _whitener(rng, img, p):
    """Whitening parameters fitted on the image's DC-removed, normalized
    patches (reference Whitener.fused_params)."""
    X = jpatches.extract_patches(jnp.asarray(img), p)
    X, _ = jpatches.contrast_normalize(jpatches.remove_dc(X)[0])
    Wm, off = Whitener().fit(X).fused_params()
    return np.array(Wm), np.array(off)


@pytest.mark.parametrize("do_dc,do_norm,whiten", [
    (True, False, False),      # the denoiser configuration
    (True, True, False),
    (True, True, True),        # extract + DC + norm + whiten
])
def test_fused_pipeline_plain_matches_pallas_interpret(rng, do_dc, do_norm,
                                                       whiten):
    # p=4 keeps the interpreted kernel's unrolled body small; the plain
    # version takes p as an ordinary argument
    img = _image(rng, (12, 21))
    p = 4
    wj = wt = None
    if whiten:
        Wm, off = _whitener(rng, img, p)
        wj = (jnp.asarray(Wm), jnp.asarray(off))
        wt = (torch.from_numpy(Wm), torch.from_numpy(off))
    got = cuda_patches.fused_patch_pipeline_p1(
        torch.from_numpy(img), p, do_dc=do_dc, do_norm=do_norm, whiten=wt)
    want = jp1(jnp.asarray(img), p, do_dc=do_dc, do_norm=do_norm,
               whiten=wj, interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("case,whiten", [
    ("flat", False), ("flat", True),   # every patch constant
    ("run257", False),                 # patch rows one past a run of 256
    ("run65", True),                   # one past a whitening run of 64
])
def test_fused_pipeline_reference_matches_pallas_at_edges(rng, case, whiten):
    """The plain version against the Pallas kernel in interpret mode where
    the CUDA kernel's blocks have edges: a flat image (every patch constant,
    so the centred sum of squares is 0 and the scales clamp to eps; integer
    pixels keep both sides' means exact), and patch rows one longer than
    the kernel's runs of patches (256 a block; 64 when it whitens at a p
    other than 8).  DC removal alone, or with normalization and
    whitening."""
    p = 4
    shape = {"flat": (12, 21), "run257": (6, 257 + p - 1),
             "run65": (6, 65 + p - 1)}[case]
    img = (np.full(shape, 137.0, np.float32) if case == "flat"
           else _image(rng, shape))
    wj = wt = None
    if whiten:
        Wm = rng.standard_normal((p * p, p * p)).astype(np.float32)
        off = rng.standard_normal(p * p).astype(np.float32)
        wj = (jnp.asarray(Wm), jnp.asarray(off))
        wt = (torch.from_numpy(Wm), torch.from_numpy(off))
    got = cuda_patches.fused_patch_pipeline_reference(
        torch.from_numpy(img), p, do_dc=True, do_norm=whiten, whiten=wt)
    want = jp1(jnp.asarray(img), p, do_dc=True, do_norm=whiten, whiten=wj,
               interpret=True)
    Hp, Wp = shape[0] - p + 1, shape[1] - p + 1
    assert tuple(got[0].shape) == (p * p, Hp * Wp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)
    if case == "flat":
        assert bool((got[1] == 137.0).all())
        assert bool((got[2] == 1e-8).all())
        if not whiten:
            assert bool((got[0] == 0.0).all())


@pytest.mark.parametrize("shape,stride", [((20, 20), 4), ((19, 17, 3), 1)])
def test_fused_pipeline_plain_ops_route(rng, shape, stride):
    # strides other than 1 and colour images take the plain ops, with the
    # reference's XLA-path contract
    from lyssandra_tpu.ops.pallas_patches import fused_patch_pipeline

    img = _image(rng, shape)
    got = cuda_patches.fused_patch_pipeline(
        torch.from_numpy(img), 8, stride, do_dc=True, do_norm=True)
    want = fused_patch_pipeline(jnp.asarray(img), 8, stride, do_dc=True,
                                do_norm=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("p,K", [(8, 64), (8, 256), (5, 49)])
def test_dct_dictionary_matches_reference(p, K):
    D = dictionaries.dct_dictionary(p, K, device="cpu")
    assert D.dtype == torch.float32 and tuple(D.shape) == (p * p, K)
    np.testing.assert_allclose(_np(D), np.asarray(jdict.dct_dictionary(p, K)),
                               atol=1e-6)
    Dc = dictionaries.dct_dictionary_color(p, K, device="cpu")
    np.testing.assert_allclose(
        _np(Dc), np.asarray(jdict.dct_dictionary_color(p, K)), atol=1e-6)


def test_dct_dictionary_rejects_non_square_K():
    with pytest.raises(ValueError, match="perfect square"):
        dictionaries.dct_dictionary(8, 200)


def test_normalize_atoms_matches_reference(rng):
    D = rng.standard_normal((16, 40)).astype(np.float32)
    D[:, 3] = 0.0              # a zero atom stays zero (1e-12 floor)
    np.testing.assert_allclose(
        _np(dictionaries.normalize_atoms(torch.from_numpy(D))),
        np.asarray(jdict.normalize_atoms(jnp.asarray(D))), atol=1e-6)
