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


def test_kernel_envelope():
    # no TPU tiling: odd p and K, any N; p up to 512 (143,360 bytes of
    # shared memory per block)
    assert cuda_select.kernel_supports(64, 1024)
    assert cuda_select.kernel_supports(5, 100)
    assert cuda_select.kernel_supports(512, 1)
    assert not cuda_select.kernel_supports(513, 1024)
    assert not cuda_select.kernel_supports(64, 0)
    assert cuda_select.smem_bytes(64) == 4 * (64 * 68 + 16 * 64)
    assert cuda_select.smem_bytes(5) == 4 * (16 * 68 + 16 * 64)
    assert cuda_select.smem_bytes(512) == 143360


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
