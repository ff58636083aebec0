"""The port's LARS-lasso homotopy (``lars``, ``lasso_lars``, ``lars_path``)
against lyssandra_tpu on the CPU: the same float32 inputs from a numpy
seed through both packages.

Tolerances follow tests/test_lasso.py: lasso solutions by their
objectives (rtol 1e-4, atol 1e-5) and codes (atol 2e-3); the cold start
and the T-constrained knot solutions of the two packages within 1e-4 (the
same events in float32, different summation orders); path knots equal in
count and kept rows, their penalties and coefficients within 1e-4."""

import importlib

import numpy as np
import pytest
import torch

import lyssandra_tpu as jlt
import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.solvers import LarsPath
from tests.conftest import make_problem

jl = importlib.import_module("lyssandra_tpu.solvers.lasso")
tl = importlib.import_module("lyssandra_tpu_torch.solvers.lasso")

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _objective(D, X, G, lam):
    R = X.astype(np.float64) - D.astype(np.float64) @ G.astype(np.float64)
    return (R * R).sum(axis=0) + lam * np.abs(G.astype(np.float64)).sum(
        axis=0)


def _assert_solution_close(D, X, got, want, lam):
    np.testing.assert_allclose(_objective(D, X, got, lam),
                               _objective(D, X, want, lam),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.fixture(scope="module")
def small():
    D, X, _ = make_problem(np.random.default_rng(0), p=16, K=32, N=16, T=3,
                           dtype=np.float32)
    return D, X


@pytest.fixture(scope="module")
def planted():
    """tests/test_lasso.py's planted 5-sparse problem, p=48, K=128, N=64."""
    rng = np.random.default_rng(1)
    p, K, N = 48, 128, 64
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    G = np.zeros((K, N))
    for n in range(N):
        G[rng.choice(K, size=5, replace=False), n] = rng.standard_normal(5)
    X = D @ G + 0.01 * rng.standard_normal((p, N))
    return D.astype(np.float32), X.astype(np.float32)


@pytest.mark.parametrize("polish", [True, False], ids=["polish", "raw"])
def test_lars_lambda_mode_matches_jax(small, polish):
    D, X = small
    lam = 0.2
    got, done = lt.lars(_t(D), _t(X), lam, polish=polish, full_result=True)
    want, jdone = jl.lars(D, X, lam, polish=polish, full_result=True)
    _assert_solution_close(D, X, got.numpy(), np.asarray(want), lam)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    # the lasso optimum: feature-sign's
    fs = lt.feature_sign(_t(D), _t(X), lam).numpy()
    _assert_solution_close(D, X, got.numpy(), fs, lam)


def test_lars_t_mode_matches_jax(small):
    D, X = small
    T = 4
    got = lt.lars(_t(D), _t(X), n_nonzero_coefs=T).numpy()
    want = np.asarray(jl.lars(D, X, n_nonzero_coefs=T))
    assert ((np.abs(got) > 1e-12).sum(axis=0) <= T).all()
    np.testing.assert_array_equal(np.abs(got) > 1e-12, np.abs(want) > 1e-12)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("unroll", [0, 8])
def test_lars_cold_unroll_matches_jax(planted, unroll):
    # each package with the same cold_unroll; and the port's unrolled cold
    # start against its own wide loop (tests/test_lasso.py's rtol 1e-5)
    D, X = planted
    lam = 0.25
    got = lt.lars(_t(D), _t(X), lam, polish=False,
                  cold_unroll=unroll).numpy()
    want = np.asarray(jl.lars(D, X, lam, polish=False, cold_unroll=unroll))
    _assert_solution_close(D, X, got, want, lam)
    wide = lt.lars(_t(D), _t(X), lam, polish=False, cold_unroll=0).numpy()
    np.testing.assert_allclose(_objective(D, X, got, lam),
                               _objective(D, X, wide, lam),
                               rtol=1e-5, atol=1e-5)
    gT = lt.lars(_t(D), _t(X), n_nonzero_coefs=4, cold_unroll=unroll).numpy()
    wT = np.asarray(jl.lars(D, X, n_nonzero_coefs=4, cold_unroll=unroll))
    assert ((np.abs(gT) > 1e-12).sum(axis=0) <= 4).all()
    np.testing.assert_allclose(gT, wT, atol=1e-4)


def test_lars_unrolled_state_matches_jax(planted):
    # the handoff state itself, slot by slot
    D, X = planted
    lam = 0.25
    A0 = X.T @ D
    want = jl._lars_unrolled_state(D.T, X.T, A0, lam, t_unroll=6,
                                   max_active=16)
    got = tl._lars_unrolled_state(_t(D.T), _t(X.T), _t(A0), lam,
                                  t_unroll=6, max_active=16)
    for name, a, b in zip(("idx", "mask", "theta", "gact", "cgw", "lt",
                           "done", "it"), want, got):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if a.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, err_msg=name)


def test_lars_path_matches_jax(small):
    D, X = small
    got = lt.lars_path(_t(D), _t(X), 0.05, max_steps=32)
    want = jl.lars_path(D, X, 0.05, max_steps=32)
    assert isinstance(got, LarsPath)
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    np.testing.assert_array_equal(got.n_knots.numpy(),
                                  np.asarray(want.n_knots))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.lambdas.numpy(), np.asarray(want.lambdas),
                               atol=1e-4)
    np.testing.assert_allclose(got.dense(32).numpy(),
                               np.asarray(want.dense(32)), atol=1e-4)
    # per-knot KKT at each kept knot's penalty (tests/test_lasso.py's)
    dense = got.dense(32).numpy().astype(np.float64)
    G, A0 = D.T.astype(np.float64) @ D, D.T.astype(np.float64) @ X
    for n in range(X.shape[1]):
        for s in np.where(got.keep[:, n].numpy())[0][1:]:
            g = dense[s, :, n]
            gr = 2 * (G @ g - A0[:, n])
            act = np.abs(g) > 1e-10
            l_s = float(got.lambdas[s, n])
            if act.any():
                assert np.abs(np.abs(gr[act]) - l_s).max() < 5e-3
            assert (np.abs(gr[~act]) <= l_s + 5e-3).all()


def test_lars_path_dense_and_t_mode(small):
    D, X = small
    path = lt.lars_path(_t(D), _t(X), n_nonzero_coefs=3, max_steps=48)
    dense = path.dense(32).numpy()
    S, N, A = path.coefs.shape
    assert dense.shape == (S, 32, N)
    for s in (0, S // 2, S - 1):
        for n in range(N):
            want = np.zeros(32, np.float32)
            for a in range(A):
                if path.mask[s, n, a]:
                    want[int(path.idx[s, n, a])] += float(path.coefs[s, n, a])
            np.testing.assert_allclose(dense[s, :, n], want, atol=0)
    np.testing.assert_array_equal(path.n_knots.numpy(),
                                  path.keep.numpy().sum(axis=0))
    # the last kept knot of the T-mode path is the T-mode solve
    sol = lt.lars(_t(D), _t(X), n_nonzero_coefs=3).numpy()
    for n in range(N):
        last = np.where(path.keep[:, n].numpy())[0][-1]
        np.testing.assert_allclose(dense[last, :, n], sol[:, n], atol=1e-5)
    want = jl.lars_path(D, X, n_nonzero_coefs=3, max_steps=48)
    np.testing.assert_array_equal(path.n_knots.numpy(),
                                  np.asarray(want.n_knots))


def test_lars_zero_above_lambda_max_and_full_active_set(small):
    D, X = small
    G0 = lt.lars(_t(D), _t(X), 1e4).numpy()
    assert (G0 == 0).all()
    lam_max = 2.0 * np.abs(X.T @ D).max(axis=1)
    got, done = lt.lars(_t(D), _t(X), float(lam_max.max()),
                        full_result=True)
    assert done.all() and (got.numpy() == 0).all()
    # two slots: a lane that wants a third atom stops with a full active
    # set, as the reference's lanes do
    got, done = lt.lars(_t(D), _t(X), 0.01, max_active=2, polish=False,
                        full_result=True)
    want, jdone = jl.lars(D, X, 0.01, max_active=2, polish=False,
                          full_result=True)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert ((np.abs(got.numpy()) > 0).sum(axis=0) <= 2).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("alg", ["lars", "lasso_lars"])
def test_encoder_lars_routes_match_jax(small, alg):
    D, X = small
    params = {"lam": 0.2}
    enc = lt.SparseEncoder(alg, params, block=8, device="cpu")
    assert lt.SparseEncoder(alg).block == 2048
    got = enc.encode(X, D).numpy()
    want = np.asarray(jlt.SparseEncoder(alg, params, block=8).encode(X, D))
    _assert_solution_close(D, X, got, want, 0.2)
    assert lt.lasso_lars is lt.lars


@pytest.mark.parametrize("mode", ["lambda", "t_mode", "path"])
def test_flag_read_interval_same_result_fewer_syncs(planted, mode,
                                                    monkeypatch):
    # reading the device flags every 8 CG iterations gives the codes of a
    # read at every iteration (the reference's decisions), bit for bit,
    # with fewer host syncs
    D, X = planted
    if mode == "path":
        def run():
            p = lt.lars_path(_t(D), _t(X), 0.1, max_steps=24)
            return torch.cat([p.lambdas.flatten(), p.coefs.flatten()])
    else:
        kw = ({"lam": 0.25, "polish": False} if mode == "lambda"
              else {"n_nonzero_coefs": 6})

        def run():
            return lt.lars(_t(D), _t(X), **kw)
    assert tl._READ_EVERY == 8
    monkeypatch.setattr(tl, "_READ_EVERY", 1)
    s0 = tl.host_syncs()
    every1 = run()
    s1 = tl.host_syncs()
    monkeypatch.setattr(tl, "_READ_EVERY", 8)
    every8 = run()
    s8 = tl.host_syncs()
    assert torch.equal(every1, every8)
    assert 0 < s8 - s1 < s1 - s0


def test_lars_cold_unroll_default_is_cpu_zero(planted, monkeypatch):
    # None means 0 on the CPU (12 on a GPU): the unrolled cold start does
    # not run here unless asked for
    D, X = planted
    called = []
    real = tl._lars_unrolled_state
    monkeypatch.setattr(tl, "_lars_unrolled_state",
                        lambda *a, **k: called.append(k) or real(*a, **k))
    lt.lars(_t(D[:, :32]), _t(X[:, :8]), 0.25)
    assert not called
    lt.lars(_t(D[:, :32]), _t(X[:, :8]), 0.25, cold_unroll=5)
    assert called[0]["t_unroll"] == 5
