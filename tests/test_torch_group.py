"""The port's group OMP against lyssandra_tpu: the unrolled block Cholesky,
the batched scan solver against the JAX scan and the fp64 oracle, and the
plain version of the fused group kernel against the Pallas kernel in
interpret mode (same float32 inputs from a numpy seed)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lyssandra_tpu import oracle
from lyssandra_tpu.ops.pallas_group import group_omp_fused as pallas_group
from lyssandra_tpu.solvers import greedy as jgreedy
from lyssandra_tpu_torch import launch_counts, reset_launch_counts
from lyssandra_tpu_torch.ops import cuda_group
from lyssandra_tpu_torch.solvers import greedy
from tests.conftest import make_problem

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit_dictionary(rng, p, K):
    D = rng.standard_normal((p, K))
    return D / np.linalg.norm(D, axis=0, keepdims=True)


@pytest.mark.parametrize("gs", [1, 3, 4, 8])
def test_chol_small_inv_matches_jax(rng, gs):
    N = 64
    B = rng.standard_normal((N, gs, gs)) / np.sqrt(gs)
    S = (B @ B.transpose(0, 2, 1) + 0.5 * np.eye(gs)).astype(np.float32)
    # a batch whose first pivot is negative (not positive definite), and
    # an (N,) jitter
    Sneg = S.copy()
    Sneg[:, 0, 0] = -1.0
    jit = (1e-3 * rng.random(N)).astype(np.float32)
    for A, jitter in ((S, 1e-9), (S, jit), (Sneg, 1e-9)):
        Linv, ok = greedy._chol_small_inv(
            _t(A), gs, _t(jitter) if isinstance(jitter, np.ndarray)
            else jitter)
        jLinv, jok = jgreedy._chol_small_inv(jnp.asarray(A), gs,
                                             jnp.asarray(jitter))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        good = ok.numpy()
        np.testing.assert_allclose(Linv.numpy()[good],
                                   np.asarray(jLinv)[good], atol=1e-5)
    assert not ok.numpy().any()          # every lane fails
    # the inverse factor inverts the Cholesky factor of S
    Linv, _ = greedy._chol_small_inv(_t(S), gs, 0.0)
    Lnp = np.linalg.cholesky(S.astype(np.float64))
    np.testing.assert_allclose(Linv.numpy() @ Lnp,
                               np.broadcast_to(np.eye(gs), S.shape),
                               atol=1e-5)


def _residuals(D, X, G):
    return np.linalg.norm(X - D @ np.asarray(G, np.float64), axis=0)


# the cases of tests/test_greedy.py (group OMP), plus gs=10 blocks, which
# take the LAPACK branch: well posed, and with unions wider than p.  There
# the ridge retry runs, and two refinement rounds leave residuals up to
# ~5e-3 on the reference's scan as well, so that case is held to the JAX
# scan only
GROUP_CASES = {
    "equal_T2": (16, 48, np.repeat(np.arange(12), 4), 2, None, "codes"),
    "equal_T3": (16, 48, np.repeat(np.arange(12), 4), 3, None, "codes"),
    "more_steps_than_groups": (16, 48, np.repeat(np.arange(4), 12), 6, None,
                               "residual"),
    "variable_group_sizes": (16, 48, np.concatenate(
        [np.zeros(10), np.ones(20), np.full(18, 2)]).astype(int), 2, None,
        "residual"),
    "eps_mode": (16, 48, np.repeat(np.arange(12), 4), 6, 0.5, "codes"),
    "gs10_lapack": (32, 60, np.repeat(np.arange(6), 10), 2, None, "codes"),
    "gs10_rank_deficient": (16, 50, np.repeat(np.arange(5), 10), 2, None,
                            "ridge"),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_group_omp_scan_matches_jax_and_oracle(rng, case):
    p, K, groups, T, eps, kind = GROUP_CASES[case]
    D, X, _ = make_problem(rng, p=p, K=K, N=24, T=4)
    Df, Xf = D.astype(np.float32), X.astype(np.float32)
    got = greedy.group_omp(Df, Xf, groups, T=T, eps=eps, fused=False,
                           device="cpu").numpy()
    jax_out = np.asarray(jgreedy.group_omp(Df, Xf, groups, T=T, eps=eps,
                                           fused=False))
    ref = oracle.group_omp(D, X, groups, T=T, eps=eps)
    if kind == "codes":
        np.testing.assert_allclose(got, ref, atol=5e-4)
        np.testing.assert_allclose(got, jax_out, atol=1e-4)
    else:
        # unions wider than p: the LS solution is not unique, so parity is
        # on the residual, which group OMP minimizes
        if kind == "residual":
            np.testing.assert_allclose(_residuals(D, X, got),
                                       _residuals(D, X, ref), atol=1e-4)
        np.testing.assert_allclose(_residuals(D, X, got),
                                   _residuals(D, X, jax_out), atol=1e-4)
    # the compact result holds the same selections as the reference's (once
    # the residual reaches ~1e-7, which group comes next is fp noise)
    res = greedy.group_omp(Df, Xf, groups, T=T, eps=eps, fused=False,
                           dense=False, device="cpu")
    jres = jgreedy.group_omp(Df, Xf, groups, T=T, eps=eps, fused=False,
                             dense=False)
    if kind != "residual":
        np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_array_equal(res.nsel.numpy(), np.asarray(jres.nsel))
    np.testing.assert_allclose(res.err.numpy(), np.asarray(jres.err),
                               atol=2e-4)


# the fused kernel's cases: the non-slow case of tests/test_pallas_omp.py,
# ragged groups (the last of 15 groups holds 6 atoms, so gs=6 and most
# groups carry 2 padded slots) and lanes that freeze (group 1 repeats group
# 0's atoms e_0..e_3; lanes 0-7 are 2 e_0, so step 1 leaves r = 0 exactly,
# step 2 takes group 1 and its Schur block is 0)
def _fused_case(rng, case):
    if case == "equal":
        p, K, N, T = 16, 64, 48, 3
        groups = np.repeat(np.arange(K // 4), 4)
    elif case == "ragged":
        p, K, N, T = 16, 62, 40, 3
        groups = np.minimum(np.arange(K) // 4, 14)
    else:
        p, K, N, T = 16, 64, 48, 3
        groups = np.repeat(np.arange(K // 4), 4)
    D = _unit_dictionary(rng, p, K)
    X = rng.standard_normal((p, N))
    if case == "freeze":
        D[:, 0:4] = D[:, 4:8] = np.eye(p)[:, :4]
        X[:, :8] = 2.0 * np.eye(p)[:, :1]
    return D.astype(np.float32), X.astype(np.float32), groups, T


@pytest.mark.parametrize("case", ["equal", "ragged", "freeze"])
def test_group_fused_reference_matches_pallas_interpret(rng, case):
    D, X, groups, T = _fused_case(rng, case)
    got = cuda_group.group_omp_fused_reference(_t(D), _t(X), groups, T)
    want = pallas_group(jnp.asarray(D), jnp.asarray(X), groups, T,
                        block=X.shape[1], interpret=True, packed=True)
    idx, gamma, err, nsel, gidx = (a.numpy() for a in got)
    widx, wgamma, werr, wnsel, wgidx = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gidx, wgidx)
    np.testing.assert_array_equal(nsel, wnsel)
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_allclose(gamma, wgamma, atol=1e-4)
    np.testing.assert_allclose(err, werr, atol=2e-4)
    if case == "freeze":
        np.testing.assert_array_equal(nsel[:8], 1)
        np.testing.assert_array_equal(gidx[:8], 0)
        np.testing.assert_array_equal(gamma[:8, 0], 2.0)
        np.testing.assert_array_equal(gamma[:8, 1:], 0.0)
        assert (nsel[8:] == T).all()
    if case == "ragged":
        assert gamma.shape == (X.shape[1], 6 * T)


def test_group_fused_reference_matches_scan(rng):
    # on a well-posed problem the kernel's semantics and the scan's agree
    # (the reference's kernel-vs-scan test, dense codes within 1e-4)
    D, X, groups, T = _fused_case(rng, "equal")
    idx, gamma, _, nsel, _ = cuda_group.group_omp_fused_reference(
        _t(D), _t(X), groups, T)
    res = greedy.GreedyResult(idx, gamma, torch.zeros(len(nsel)), nsel * 4)
    np.testing.assert_allclose(
        greedy._scatter_dense(res, D.shape[1]).numpy(),
        greedy.group_omp(D, X, groups, T, fused=False,
                         device="cpu").numpy(), atol=1e-4)


def test_group_omp_on_cpu_launches_nothing(rng):
    D, X, groups, T = _fused_case(rng, "equal")
    reset_launch_counts()
    got = cuda_group.group_omp_fused(_t(D), _t(X), groups, T)
    want = cuda_group.group_omp_fused_reference(_t(D), _t(X), groups, T)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    greedy.group_omp(_t(D), _t(X), groups, T)
    greedy.group_omp(_t(D), _t(X), groups, T, dense=False)
    assert set(launch_counts().values()) == {0}
    assert not greedy._group_fused_supported(_t(D), _t(X), 4, T)
    with pytest.raises(ValueError, match="T <= n_groups"):
        cuda_group.group_omp_fused(_t(D), _t(X), groups, 17)


def test_group_kernel_envelope():
    assert cuda_group.kernel_supports(64, 4, 4)
    assert cuda_group.kernel_supports(512, 8, 4)
    assert cuda_group.kernel_supports(16, 1, 32)
    assert not cuda_group.kernel_supports(64, 9, 1)      # gs = 9
    assert not cuda_group.kernel_supports(64, 3, 11)     # T * gs = 33
    assert not cuda_group.kernel_supports(513, 4, 4)
    A = 16
    assert cuda_group.lane_smem_bytes(64, 4, 4) == 4 * (
        128 + A * 65 + A * 17 + 5 * A + 2 * A * 5 + 32 + 4 * A + 4 + 1)


def test_slot_table_orders_members_and_pads():
    groups = np.array([2, 0, 2, 1, 0, 2])
    members, valid, ng, gs = cuda_group.slot_table(groups)
    assert (ng, gs) == (3, 3)
    np.testing.assert_array_equal(members, [[1, 4, 0], [3, 0, 0], [0, 2, 5]])
    np.testing.assert_array_equal(
        valid, [[1, 1, 0], [1, 0, 0], [1, 1, 1]])
    D = torch.arange(12.0).reshape(2, 6)
    Dp = cuda_group.slot_dictionary(D, members, valid)
    np.testing.assert_array_equal(
        Dp.numpy(), [[1, 4, 0, 3, 0, 0, 0, 2, 5],
                     [7, 10, 0, 9, 0, 0, 6, 8, 11]])
    gidx = torch.tensor([[2, 0], [1, 1]], dtype=torch.int32)
    np.testing.assert_array_equal(
        cuda_group._atom_ids(members, gidx).numpy(),
        [[0, 2, 5, 1, 4, 0], [3, 0, 0, 3, 0, 0]])
