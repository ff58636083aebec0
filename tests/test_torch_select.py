"""The port's fused OMP selection (K7) and the path that runs it,
``_omp_impl(fused_select=True)``, against lyssandra_tpu on the CPU: the
plain version of the kernel against the Pallas kernel in interpret mode,
and the solver against the reference's solver with the same keyword (the
same float32 inputs from a numpy seed).

Tolerances: picks equal exactly (the two sides run the same float32 or
bf16-rounded products, and the tie rule is exact); solver results as
tests/test_pallas_omp.py holds the kernel to the scan (idx and nsel equal,
gamma within 2e-5, err within 2e-4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from lyssandra_tpu.ops.pallas_select import (
    select_abs_argmax as pallas_select_abs_argmax,
)
from lyssandra_tpu.solvers import greedy as jgreedy
from lyssandra_tpu_torch.ops import cuda_select, launch_counts
from lyssandra_tpu_torch.solvers import greedy
from tests.conftest import make_problem

torch.set_num_threads(1)

_HI = lax.Precision.HIGHEST


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _select_case(rng, case):
    """r (1024, 16), D (16, 256): Gaussian, or with atom 7 a copy of atom 3
    and the first 64 rows of r equal to atom 3, so that those rows tie
    exactly between atoms 3 and 7 at the maximum (the tie case of
    tests/test_pallas_patches.py, made certain to bind)."""
    r = rng.standard_normal((1024, 16)).astype(np.float32)
    D = rng.standard_normal((16, 256)).astype(np.float32)
    if case == "tie":
        D /= np.linalg.norm(D, axis=0, keepdims=True)
        D[:, 7] = D[:, 3]
        r[:64] = D[:, 3]
    return r, D


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["gaussian", "tie"])
def test_select_reference_matches_pallas_interpret(rng, case, bf16):
    r, D = _select_case(rng, case)
    got = cuda_select.select_abs_argmax_reference(_t(r), _t(D), bf16=bf16)
    want = pallas_select_abs_argmax(jnp.asarray(r), jnp.asarray(D),
                                    bf16=bf16, block=512, interpret=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1024,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "tie":
        np.testing.assert_array_equal(got.numpy()[:64], 3)


def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing(rng):
    r, D = _select_case(rng, "gaussian")
    before = launch_counts()
    for bf16 in (False, True):
        got = cuda_select.select_abs_argmax(_t(r), _t(D), bf16=bf16)
        want = cuda_select.select_abs_argmax_reference(_t(r), _t(D),
                                                       bf16=bf16)
        assert torch.equal(got, want)
    assert launch_counts() == before
    # a device with no kernel raises: no silent fallback
    with pytest.raises(ValueError, match="no kernel"):
        cuda_select.select_abs_argmax(_t(r).to("meta"), _t(D).to("meta"))


def _straddle_case(rng, N, p, K, tie):
    """Gaussian r (N, p) and unit-norm D (p, K) at shapes that straddle the
    kernel's tiles (128 atoms, 128 rows, p in steps of 16 and 32); with
    ``tie``, atom 128 is a copy of atom 127 and the first 64 rows of r are
    atom 127, so those rows tie exactly across the boundary between two
    atom tiles."""
    r = rng.standard_normal((N, p)).astype(np.float32)
    D = rng.standard_normal((p, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    if tie:
        D[:, 128] = D[:, 127]
        r[:64] = D[:, 127]
    return r, D


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("N,p,K,tie", [
    (130, 5, 129, False),      # p not a multiple of 16, one atom past a tile
    (130, 17, 257, False),     # p one past 16, one atom past two tiles
    (130, 17, 257, True),      # equal maxima at atoms 127 and 128
], ids=["p5_K129", "p17_K257", "tie127_128"])
def test_select_reference_matches_pallas_interpret_across_tiles(
        rng, N, p, K, tie, bf16):
    r, D = _straddle_case(rng, N, p, K, tie)
    got = cuda_select.select_abs_argmax_reference(_t(r), _t(D), bf16=bf16)
    want = pallas_select_abs_argmax(jnp.asarray(r), jnp.asarray(D),
                                    bf16=bf16, block=N, interpret=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == (N,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if tie:
        np.testing.assert_array_equal(got.numpy()[:64], 127)


def test_kernel_envelope():
    # no TPU tiling: odd p and K, any N; p up to 512 in both modes
    assert cuda_select.kernel_supports(64, 1024)
    assert cuda_select.kernel_supports(5, 100)
    assert cuda_select.kernel_supports(512, 1)
    assert cuda_select.kernel_supports(64, 100_000)
    assert not cuda_select.kernel_supports(513, 1024)
    assert not cuda_select.kernel_supports(64, 0)
    # float32: rows of r transposed (p rounded up to 32, rows of 132
    # floats), two 32 x 128 slices of D
    assert cuda_select.smem_bytes(64, 1024) == 4 * (64 * 132 + 2 * 32 * 128)
    assert cuda_select.smem_bytes(5, 100) == 4 * (32 * 132 + 2 * 32 * 128)
    # p=512 takes 64 rows a block in float32 (128 would need 270 KB)
    assert cuda_select.smem_bytes(512, 1) == 4 * (512 * 68 + 2 * 32 * 128)
    # bf16 at the Batch-OMP shape: all of D (1,024 atoms, p + 8 = 72 bf16
    # values a row) and 8 warps' 32 rows of r stay in shared memory
    assert cuda_select.resident(64, 1024)
    assert cuda_select.smem_bytes(64, 1024, bf16=True) == \
        2 * (1024 * 72 + 256 * 72)
    # bf16 where D does not fit: 128 rows of r (p rounded up to 16, plus
    # 8), three chunks of 128 atoms by min(p, 64) plus 8, streamed
    assert not cuda_select.resident(64, 1345)
    assert cuda_select.smem_bytes(64, 1345, bf16=True) == \
        2 * (128 * 72 + 3 * 128 * 72)
    assert not cuda_select.resident(512, 1)
    assert cuda_select.smem_bytes(512, 1, bf16=True) == \
        2 * (128 * 520 + 3 * 128 * 72)


@pytest.mark.parametrize("p,K,rows_f32,resident", [
    (1, 7, 128, True), (16, 4586, 128, False), (17, 257, 128, True),
    (64, 1344, 128, True), (64, 1345, 128, False), (65, 100, 128, False),
    (256, 300, 128, False), (257, 300, 64, False), (512, 1024, 64, False)])
def test_block_rows_and_smem_at_each_tile_choice(p, K, rows_f32, resident):
    """float32: 128 rows a block while p rounded up to 32 is at most 256,
    64 above.  bf16: all of D resident beside 8 warps of 32 rows where p
    rounded up to 16 is at most 64 and it fits, else 128 rows a block with
    D streamed.  Each choice fits the 227 KB a block may opt in to, so the
    envelope runs to p=512 and any K in both modes."""
    pp32, pp16 = -(-p // 32) * 32, -(-p // 16) * 16
    assert cuda_select.block_rows(p) == rows_f32
    assert cuda_select.smem_bytes(p, K) == 4 * (pp32 * (rows_f32 + 4)
                                                + 2 * 32 * 128)
    assert cuda_select.resident(p, K) == resident
    if resident:
        assert cuda_select.smem_bytes(p, K, bf16=True) == 2 * (
            -(-K // 64) * 64 * (pp16 + 8) + 256 * (pp16 + 8))
    else:
        assert cuda_select.smem_bytes(p, K, bf16=True) == 2 * (
            128 * (pp16 + 8) + 3 * 128 * (min(pp16, 64) + 8))
    assert max(cuda_select.smem_bytes(p, K),
               cuda_select.smem_bytes(p, K, bf16=True)) <= 232448
    assert cuda_select.kernel_supports(p, K)


@pytest.mark.parametrize("corr_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("eps_mode", [False, True], ids=["T", "eps"])
def test_omp_impl_fused_select_matches_jax(rng, eps_mode, corr_dtype):
    """The reference's gate sends fused_select=True to its XLA matmul and
    argmax pair off a TPU, so on the CPU its solver runs the unfused
    selection; the port's wrapper runs its plain version on CPU tensors.
    Both hold the same semantics the kernels hold on their chips."""
    D, X, _ = make_problem(rng, p=16, K=64, N=300, T=4)
    D, X = D.astype(np.float32), X.astype(np.float32)
    X[:, ::3] *= 0.1
    eps = 0.2 if eps_mode else 0.0
    kw = dict(T=6, eps_mode=eps_mode, corr_dtype=corr_dtype)
    got = greedy._omp_impl(_t(D), _t(X), eps, fused_select=True, **kw)
    want = jgreedy._omp_impl(jnp.asarray(D), jnp.asarray(X), eps,
                             precision=_HI, fused_select=True, **kw)
    idx, gamma, err, nsel = (a.numpy() for a in got)
    np.testing.assert_array_equal(nsel, np.asarray(want.nsel))
    np.testing.assert_array_equal(idx, np.asarray(want.idx))
    np.testing.assert_allclose(gamma, np.asarray(want.gamma), atol=2e-5)
    np.testing.assert_allclose(err, np.asarray(want.err), atol=2e-4)
    # on CPU tensors the fused selection is bit-identical to the unfused one
    plain = greedy._omp_impl(_t(D), _t(X), eps, fused_select=False, **kw)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
