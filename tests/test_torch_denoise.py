"""The port's denoiser against lyssandra_tpu and the fp64 oracle (same
float32 images and noise from a numpy seed; JAX on the CPU, its Pallas
kernels in interpret mode)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lyssandra_tpu_torch as lt
from lyssandra_tpu import oracle
from lyssandra_tpu.config import DenoiseConfig as JDenoiseConfig
from lyssandra_tpu_torch.utils.interop import denoiser_from_reference

# the modules, not the functions their packages re-export under that name
jdenoise = importlib.import_module("lyssandra_tpu.apps.denoise")
tdenoise = importlib.import_module("lyssandra_tpu_torch.apps.denoise")

torch.set_num_threads(1)


def _toy_image(n=64):
    # the image of tests/test_apps.py
    x = np.linspace(0, 2 * np.pi, n)
    return 100 + 60 * np.outer(np.sin(x), np.cos(x)) + 20 * np.outer(
        np.cos(2 * x), np.sin(3 * x))


def _psnr(out, img):
    return oracle.psnr(np.asarray(out, np.float64), img)


@pytest.mark.parametrize("T_max", [16, 8])
def test_denoise_matches_oracle_and_reference(rng, T_max):
    # T_max=16 takes the two-phase coder, T_max=8 the blocked Batch-OMP
    # (block < N exercises the chunking).  PSNR budgets: 0.05 dB against
    # the fp64 oracle (the reference's own), 0.01 dB against the JAX
    # package (both float32)
    img = _toy_image()
    sigma = 25.0
    noisy = (img + sigma * rng.standard_normal(img.shape)).astype(np.float32)
    D = oracle.dct_dictionary(8, 64)
    cfg = dict(patch=8, sigma=sigma, T_max=T_max, block=1024)
    out = lt.denoise(noisy, D, sigma, cfg=lt.DenoiseConfig(**cfg),
                     device="cpu")
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == img.shape
    ref = oracle.denoise(noisy.astype(np.float64), D, sigma, T_max=T_max)
    jax_out = jdenoise.denoise(noisy, D, sigma, cfg=JDenoiseConfig(**cfg))
    p_out = _psnr(out.numpy(), img)
    assert p_out > _psnr(noisy, img) + 3.0
    assert abs(p_out - _psnr(ref, img)) < 0.05
    assert abs(p_out - _psnr(jax_out, img)) < 0.01
    assert abs(lt.psnr(out, img) - jdenoise.psnr(jax_out, img)) < 0.01


def _straggler_problem(rng, N=96, p=16, K=64):
    """Signals of 4-6 atoms: a T1=2 first pass leaves many lanes
    unconverged (tests/test_apps.py)."""
    D = rng.standard_normal((p, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    G0 = np.zeros((K, N), np.float32)
    for i in range(N):
        sup = rng.choice(K, size=4 + (i % 3), replace=False)
        G0[sup, i] = rng.standard_normal(len(sup))
    return D, (D @ G0).astype(np.float32)


def test_eps_two_phase_stragglers_match_reference(rng):
    # cap=16 below the straggler count: several compaction rounds run
    D, X = _straggler_problem(rng)
    kw = dict(eps=1e-3, T1=2, T_max=6, cap=16)
    want = np.asarray(jdenoise._eps_two_phase(
        jnp.asarray(D), jnp.asarray(X), interpret=True, **kw))
    got = tdenoise._eps_two_phase(torch.from_numpy(D), torch.from_numpy(X),
                                  **kw).numpy()
    assert (np.count_nonzero(got, axis=0) > 2).sum() > 16
    np.testing.assert_allclose(got, want, atol=1e-4)
    energy = tdenoise._eps_two_phase(
        torch.from_numpy(D), torch.from_numpy(X), order="energy", **kw)
    np.testing.assert_array_equal(energy.numpy(), got)


def test_ksvd_dictionary_carries_over(rng):
    # a dictionary learned by the reference's K-SVD denoises the same in
    # the port: PSNR within 0.01 dB (float32 on both sides)
    from lyssandra_tpu.config import KSVDConfig
    from lyssandra_tpu.dict_learning.ksvd import KSVDLearner
    from lyssandra_tpu.utils.datasets import patch_dataset

    img = _toy_image(48)
    sigma = 20.0
    noisy = (img + sigma * rng.standard_normal(img.shape)).astype(np.float32)
    train = patch_dataset([noisy.astype(np.float64)], p=8, n_patches=1500,
                          seed=3).astype(np.float32)
    D = np.asarray(KSVDLearner(
        KSVDConfig(K=64, T=4, n_iter=2, init="dct")).fit(train).D_)
    cfg = JDenoiseConfig(sigma=sigma, T_max=12, block=4096)
    want = np.asarray(jdenoise.Denoiser(D, cfg)(noisy))
    got = denoiser_from_reference(D, dataclasses.asdict(cfg),
                                  device="cpu")(noisy).numpy()
    assert abs(_psnr(got, img) - _psnr(want, img)) < 0.01


def test_denoiser_mesh_not_ported():
    # a mesh that is not a Mesh raises TypeError; a CPU mesh is taken and
    # leaves the two-phase fast path
    D = lt.dct_dictionary(8, 64, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        lt.Denoiser(D, mesh=object())
    den = lt.Denoiser(D, mesh=lt.parallel.make_mesh(devices=["cpu"] * 2))
    assert not den._fast_path() and den.D.device == torch.device("cpu")


def test_fast_path_follows_the_kernel_envelope(rng, monkeypatch):
    # On the GPU the two-phase coder is taken only where a fused kernel
    # (the Gram form, or above its cap the residual form) takes the shape;
    # elsewhere the blocked Batch-OMP path codes the patches.  A CPU
    # dictionary posing as a CUDA one (Tensor.is_cuda) and stand-in
    # envelopes show the routing without a GPU.
    from lyssandra_tpu_torch.ops import cuda_omp
    from lyssandra_tpu_torch.ops.cuda_patches import (
        fused_patch_pipeline_reference,
    )

    den = lt.Denoiser(lt.dct_dictionary(8, 64, device="cpu"),
                      lt.DenoiseConfig(sigma=20.0, T_max=16, block=200))
    assert den._fast_path()              # CPU: the kernel's plain version
    asked = []
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))
    monkeypatch.setattr(cuda_omp, "kernel_supports",
                        lambda *shape: asked.append(shape) or False)
    monkeypatch.setattr(cuda_omp, "residual_kernel_supports",
                        lambda *shape: False)
    assert not den._fast_path()
    assert asked and asked[-1][0] == 64 and asked[-1][-1] == 10

    def no_fused(*args, **kwargs):
        raise AssertionError("the two-phase coder ran outside the envelope")

    blocks = []

    def batch_omp(D, X, T, eps=None):
        blocks.append((X.shape[1], T, eps))
        return torch.zeros((D.shape[1], X.shape[1]))

    monkeypatch.setattr(tdenoise, "_denoise_fused_impl", no_fused)
    monkeypatch.setattr(tdenoise, "fused_patch_pipeline",
                        fused_patch_pipeline_reference)
    monkeypatch.setattr(tdenoise, "batch_omp", batch_omp)
    noisy = torch.from_numpy((255.0 * rng.random((24, 24))).astype(
        np.float32))
    den(noisy)
    assert [b[0] for b in blocks] == [200, 89]     # 289 patches of 8 x 8
    assert all(b[1] == 16 for b in blocks)
    monkeypatch.setattr(cuda_omp, "residual_kernel_supports",
                        lambda *shape: True)
    assert den._fast_path()              # above the Gram form's cap
    monkeypatch.setattr(cuda_omp, "residual_kernel_supports",
                        lambda *shape: False)
    monkeypatch.setattr(cuda_omp, "kernel_supports", lambda *shape: True)
    assert den._fast_path()


def test_denoise_colour_patches_beyond_p512(rng):
    # 16 x 16 colour patches (p = 768) denoise on the CPU as the reference
    # does (its blocked Batch-OMP path off the TPU), within 0.01 dB
    from lyssandra_tpu.ops.dictionaries import dct_dictionary_color

    img = np.stack([_toy_image(32), _toy_image(32).T, 255 - _toy_image(32)],
                   axis=-1)
    noisy = (img + 25.0 * rng.standard_normal(img.shape)).astype(np.float32)
    D = np.asarray(dct_dictionary_color(16, 256))
    assert D.shape == (768, 256)
    cfg = dict(patch=16, sigma=25.0, T_max=12, block=4096)
    got = lt.denoise(noisy, D, 25.0, cfg=lt.DenoiseConfig(**cfg),
                     device="cpu").numpy()
    want = np.asarray(jdenoise.denoise(noisy, D, 25.0,
                                       cfg=JDenoiseConfig(**cfg)))
    assert got.shape == img.shape and np.isfinite(got).all()
    assert abs(_psnr(got, img) - _psnr(want, img)) < 0.01


def test_denoise_colour_image(rng):
    # (H, W, 3) images take extract + DC removal over a (3 p^2, K)
    # dictionary; within 0.01 dB of the reference
    from lyssandra_tpu.ops.dictionaries import dct_dictionary_color

    img = np.stack([_toy_image(40), _toy_image(40).T, 255 - _toy_image(40)],
                   axis=-1)
    noisy = (img + 25.0 * rng.standard_normal(img.shape)).astype(np.float32)
    D = np.asarray(dct_dictionary_color(8, 64))
    cfg = dict(sigma=25.0, T_max=12, block=4096)
    got = lt.denoise(noisy, D, 25.0, cfg=lt.DenoiseConfig(**cfg),
                     device="cpu").numpy()
    want = np.asarray(jdenoise.denoise(noisy, D, 25.0,
                                       cfg=JDenoiseConfig(**cfg)))
    assert got.shape == img.shape
    assert abs(_psnr(got, img) - _psnr(want, img)) < 0.01


@pytest.mark.parametrize("colour", [False, True], ids=["grey96", "colour64"])
def test_denoise_adaptive_matches_reference(rng, colour):
    # the adaptive pipeline (K-SVD on the noisy image's patches, then the
    # denoise) in both packages: PSNR within 0.05 dB.  The K-SVD starts
    # from the DCT, so both fits start from the same D
    if colour:
        img = np.stack([_toy_image(64), _toy_image(64).T,
                        255 - _toy_image(64)], axis=-1)
    else:
        img = _toy_image(96)
    noisy = (img + 25.0 * rng.standard_normal(img.shape)).astype(np.float32)
    kw = dict(K=64, n_iter=4, n_train=2000)
    got, D = tdenoise.denoise_adaptive(
        noisy, 25.0, cfg=lt.DenoiseConfig(sigma=25.0, T_max=8),
        return_dictionary=True, device="cpu", **kw)
    want = jdenoise.denoise_adaptive(
        noisy, 25.0, cfg=JDenoiseConfig(sigma=25.0, T_max=8), **kw)
    assert got.shape == img.shape
    assert tuple(D.shape) == ((192 if colour else 64), 64)
    assert abs(_psnr(got.numpy(), img) - _psnr(want, img)) < 0.05
    assert _psnr(got.numpy(), img) > _psnr(noisy, img) + 3.0
