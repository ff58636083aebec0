"""The port's online dictionary learning and its in-loop coder
``feature_sign_scan`` against lyssandra_tpu and the fp64 oracle: the same
float32 inputs from a numpy seed go through both packages on the CPU, and
states are carried across as numpy arrays (the two packages' init_dictionary
draw from different generators)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lyssandra_tpu_torch as lt
from lyssandra_tpu import oracle
from lyssandra_tpu.config import OnlineDLConfig as JOnlineDLConfig
from lyssandra_tpu.solvers.lasso import feature_sign_scan as j_fss
from lyssandra_tpu_torch.solvers.lasso import host_syncs
from lyssandra_tpu_torch.utils.interop import online_state_from_reference
from tests.conftest import make_problem

# the modules, not the names their packages re-export
jonline = importlib.import_module("lyssandra_tpu.dict_learning.online")
tonline = importlib.import_module("lyssandra_tpu_torch.dict_learning.online")

torch.set_num_threads(1)

LAM = 0.15
SMALL = dict(K=24, lam=LAM, batch_size=64, chunk_batches=2, seed=0)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _lasso_problem(rng, N=64):
    D, X, _ = make_problem(rng, p=16, K=24, N=N, T=3)
    return D.astype(np.float32), X.astype(np.float32)


def _jax_state(D, K=24, p=16):
    return jonline.OnlineDLState(_j(D), jnp.zeros((K, K)), jnp.zeros((p, K)),
                                 jnp.zeros((), jnp.int32))


def _torch_state(D, K=24, p=16):
    return online_state_from_reference(D, np.zeros((K, K)), np.zeros((p, K)),
                                       0, device="cpu")


# ---- the in-loop coder ---------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"cold_unroll": 5}, {"warm_start": 3},
    {"warm_start": 3, "warm_seed": "fista"}, {"max_iter": 2},
    {"n_activate": 2, "max_active": 8},
], ids=["cold", "unrolled", "omp-seed", "fista-seed", "polish", "narrow"])
def test_feature_sign_scan_matches_jax(rng, kw):
    # the same trip rules as the reference's while-loop, so the codes agree
    # to float32 rounding (atol 1e-5); max_iter=2 leaves lanes undone, so
    # the FISTA-100 polish runs on both sides
    D, X = _lasso_problem(rng)
    want = np.asarray(j_fss(_j(D), _j(X), LAM, **kw))
    got = lt.feature_sign_scan(_t(D), _t(X), LAM, **kw)
    assert got.shape == (24, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_feature_sign_scan_meets_kkt_and_the_oracle(rng):
    # tests/test_lasso.py's KKT rule (active stationarity 1e-3, inactive
    # |grad| <= lam + 1e-3) and the oracle's objective within rtol 1e-4
    D, X = _lasso_problem(rng, N=32)
    G = lt.feature_sign_scan(_t(D), _t(X), LAM).numpy().astype(np.float64)
    Dd, Xd = D.astype(np.float64), X.astype(np.float64)
    grad = 2.0 * Dd.T @ (Dd @ G - Xd)
    act = np.abs(G) > 1e-10
    assert np.abs(grad + LAM * np.sign(G))[act].max() < 1e-3
    assert np.abs(grad)[~act].max() <= LAM + 1e-3
    Gr = oracle.lasso(Dd, Xd, LAM)

    def obj(Gm):
        R = Xd - Dd @ Gm
        return (R * R).sum(axis=0) + LAM * np.abs(Gm).sum(axis=0)

    np.testing.assert_allclose(obj(G), obj(Gr), rtol=1e-4, atol=1e-6)


def test_feature_sign_scan_syncs_and_checks(rng):
    # each exit check is one host read; a run whose lanes all finish in the
    # loop reads one more flag (the polish gate) and skips the polish
    D, X = _lasso_problem(rng, N=16)
    s0 = host_syncs()
    lt.feature_sign_scan(_t(D), _t(X), LAM)
    assert host_syncs() - s0 > 1
    with pytest.raises(ValueError, match="max_iter"):
        lt.feature_sign_scan(_t(D), _t(X), LAM, max_iter=0)
    with pytest.raises(ValueError, match="warm_seed"):
        lt.feature_sign_scan(_t(D), _t(X), LAM, warm_start=2,
                             warm_seed="lars")


@pytest.mark.parametrize("cb", [1, 2, 4, 3])
def test_code_batch_blocks_match_jax(rng, cb):
    # code_blocks codes sub-blocks one after another: the codes equal one
    # call's (lanes are independent) and the reference's; a count that does
    # not divide the minibatch (3 of 64) codes it whole
    D, X = _lasso_problem(rng)
    opts = dict(max_active=64, max_iter=60, max_inner=6, warm_start=0,
                cold_unroll=0)
    got = tonline._code_batch(_t(D), _t(X), LAM, "feature_sign", opts, cb)
    whole = tonline._code_batch(_t(D), _t(X), LAM, "feature_sign", opts, 1)
    want = jonline._code_batch(_j(D), _j(X), LAM, "feature_sign", opts, cb)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_code_batch_fista_matches_jax(rng):
    D, X = _lasso_problem(rng)
    got = tonline._code_batch(_t(D), _t(X), LAM, "fista", {})
    want = jonline._code_batch(_j(D), _j(X), LAM, "fista", {})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError):
        tonline._code_batch(_t(D), _t(X), LAM, "lars", {})


# ---- one step and the atom sweep ----------------------------------------

@pytest.mark.parametrize("coder", ["feature_sign", "fista"])
def test_online_dl_step_matches_jax_and_oracle(rng, coder):
    # tests/test_dict_learning.py's tolerance against the oracle (5e-3,
    # feature-sign only: the oracle codes by feature-sign); against the
    # reference within 1e-4
    D, X, _ = make_problem(rng, p=16, K=24, N=100, T=3)
    A, B = np.zeros((24, 24)), np.zeros((16, 24))
    cfg = lt.OnlineDLConfig(K=24, lam=LAM)
    got, G = lt.online_dl_step(_torch_state(D), X.astype(np.float32), cfg,
                               coder=coder)
    want, Gj = jonline.online_dl_step(_jax_state(D), _j(X),
                                      JOnlineDLConfig(K=24, lam=LAM),
                                      coder=coder)
    assert int(got.step) == 1 and got.step.device.type == "cpu"
    np.testing.assert_allclose(G.numpy(), np.asarray(Gj), atol=1e-4)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    if coder == "feature_sign":
        for a, b in zip(got[:3], oracle.online_dl_step(D, A, B, X, LAM)):
            np.testing.assert_allclose(a.numpy(), b, atol=5e-3)


def test_dict_update_matches_jax_and_keeps_unused_atoms(rng):
    # the Gauss-Seidel sweep, two sweeps: atoms with A_kk < 1e-10 keep
    # their value, every atom ends inside the unit ball, the inputs are
    # not changed
    D, X = _lasso_problem(rng, N=80)
    G = oracle.lasso(D.astype(np.float64), X.astype(np.float64), LAM)
    G[[3, 11]] = 0.0
    A, B = G @ G.T, X @ G.T
    Dt, At, Bt = _t(D), _t(A), _t(B)
    copies = [a.clone() for a in (Dt, At, Bt)]
    got = tonline._dict_update_body(Dt, At, Bt, 2)
    want = jonline._dict_update_body(_j(D), _j(A), _j(B), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for a, b in zip((Dt, At, Bt), copies):
        assert torch.equal(a, b)
    assert torch.equal(got[:, [3, 11]], Dt[:, [3, 11]])
    assert (torch.linalg.norm(got, dim=0) <= 1.0 + 1e-6).all()


def test_online_chunk_reads_nothing_on_the_host(rng):
    # with the FISTA coder (no loop exits) a chunk makes no host read, and
    # its per-minibatch objectives and nnz match the reference's
    D, X = _lasso_problem(rng, N=128)
    Xc = X.reshape(16, 2, 64).transpose(1, 0, 2).copy()
    kw = dict(n_sweeps=1, coder="fista", max_active=64, max_iter=60,
              max_inner=6)
    s0 = host_syncs()
    got = tonline._online_chunk(_t(D), torch.zeros(24, 24),
                                torch.zeros(16, 24), _t(Xc), LAM, 1.0, **kw)
    assert host_syncs() == s0
    want = jonline._online_chunk(_j(D), jnp.zeros((24, 24)),
                                 jnp.zeros((16, 24)), _j(Xc), LAM, 1.0, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_holdout_objective_matches_jax(rng):
    D, X = _lasso_problem(rng, N=48)
    got = float(tonline.holdout_objective(_t(D), _t(X), LAM))
    want = float(jonline.holdout_objective(_j(D), _j(X), LAM))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---- the learner ---------------------------------------------------------

def _data(rng, N):
    _, X, _ = make_problem(rng, p=16, K=24, N=N, T=3)
    return X.astype(np.float32)


def test_fit_from_a_carried_state_matches_jax(rng):
    # both learners start from the same D (carried across as numpy) and
    # see the same minibatch stream (numpy permutations): D within 2e-3,
    # the holdout trace within rtol 1e-4, the same history keys and steps
    Xf = _data(rng, 512)
    D0 = make_problem(np.random.default_rng(1), p=16, K=24)[0]
    j = jonline.OnlineDictionaryLearner(JOnlineDLConfig(**SMALL))
    j.state = _jax_state(D0)
    j.fit(Xf[:, :448], n_epochs=2, seed=3, holdout=Xf[:, 448:])
    t = lt.OnlineDictionaryLearner(lt.OnlineDLConfig(**SMALL))
    t.state = _torch_state(D0)
    t.fit(Xf[:, :448], n_epochs=2, seed=3, holdout=Xf[:, 448:])
    np.testing.assert_allclose(t.D_.numpy(), np.asarray(j.D_), atol=2e-3)
    assert [set(h) for h in t.history_] == [set(h) for h in j.history_]
    for key in ("holdout_objective", "batch_objective"):
        np.testing.assert_allclose([h[key] for h in t.history_],
                                   [h[key] for h in j.history_], rtol=1e-4)
    assert [h["step"] for h in t.history_] == [h["step"] for h in j.history_]
    assert int(t.state.step) == 14


def test_fit_inits_from_the_first_minibatch_of_the_stream(rng):
    Xf = _data(rng, 256)
    cfg = lt.OnlineDLConfig(**SMALL)
    learner = lt.OnlineDictionaryLearner(cfg, device="cpu")
    Xt = _t(Xf)
    perm = np.random.default_rng(7).permutation(256)
    D0 = lt.init_dictionary(Xt[:, torch.from_numpy(perm[:64])], 24, "data",
                            0)
    real = tonline._online_chunk
    seen = []

    def first_chunk(D, *a, **kw):
        seen.append(D.clone())
        return real(D, *a, **kw)

    tonline._online_chunk = first_chunk
    try:
        learner.fit(Xf, seed=7)
    finally:
        tonline._online_chunk = real
    assert torch.equal(seen[0], D0) and len(seen) == 2


def test_fit_equals_partial_fit_in_the_same_order(rng):
    # tests/test_dict_learning.py's pair: fit's in-loop coder and
    # partial_fit's feature_sign solve the same lasso; D within 2e-3
    Xf = _data(rng, 256)
    cfg = lt.OnlineDLConfig(**SMALL)
    a = lt.OnlineDictionaryLearner(cfg).fit(_t(Xf), seed=3)
    b = lt.OnlineDictionaryLearner(cfg)
    perm = np.random.default_rng(3).permutation(256)
    for s in range(0, 256, 64):
        b.partial_fit(_t(Xf[:, perm[s:s + 64]]))
    np.testing.assert_allclose(a.D_.numpy(), b.D_.numpy(), atol=2e-3)
    assert [h["step"] for h in b.history_] == [1, 2, 3, 4]
    assert set(b.history_[0]) == {"step", "batch_objective", "avg_nnz"}


def test_code_blocks_fit_matches_unblocked(rng):
    Xf = _data(rng, 256)
    a = lt.OnlineDictionaryLearner(lt.OnlineDLConfig(**SMALL, code_blocks=1),
                                   device="cpu").fit(Xf, seed=3)
    b = lt.OnlineDictionaryLearner(lt.OnlineDLConfig(**SMALL, code_blocks=2),
                                   device="cpu").fit(Xf, seed=3)
    np.testing.assert_allclose(a.D_.numpy(), b.D_.numpy(), atol=2e-3)


def test_holdout_objective_decreases(rng):
    Xf = _data(rng, 512)
    learner = lt.OnlineDictionaryLearner(lt.OnlineDLConfig(**SMALL),
                                         device="cpu").fit(
        Xf[:, :448], n_epochs=2, holdout=Xf[:, 448:])
    trace = [h["holdout_objective"] for h in learner.history_]
    assert len(trace) == 8 and trace[-1] < trace[0]
    assert (torch.linalg.norm(learner.D_, dim=0) <= 1.0 + 1e-5).all()


def test_kill_and_resume(rng, tmp_path):
    # a fit killed after 3 chunks resumes from the port's Workspace and
    # finishes the same stream: the holdout trace equals an uninterrupted
    # run's (rtol 1e-4), D within 2e-4
    Xf = _data(rng, 384)
    hold = Xf[:, :64]
    cfg = lt.OnlineDLConfig(**SMALL)
    a = lt.OnlineDictionaryLearner(cfg, device="cpu").fit(
        Xf, n_epochs=2, seed=5, holdout=hold)
    trace_a = [h["holdout_objective"] for h in a.history_]

    ws = lt.Workspace(str(tmp_path / "odl"))
    b = lt.OnlineDictionaryLearner(cfg, device="cpu")
    real_chunk = tonline._online_chunk
    calls = {"n": 0}

    def dying_chunk(*args, **kw):
        if calls["n"] >= 3:
            raise KeyboardInterrupt("simulated preemption")
        calls["n"] += 1
        return real_chunk(*args, **kw)

    tonline._online_chunk = dying_chunk
    try:
        with pytest.raises(KeyboardInterrupt):
            b.fit(Xf, n_epochs=2, seed=5, holdout=hold, workspace=ws)
    finally:
        tonline._online_chunk = real_chunk

    c = lt.OnlineDictionaryLearner(cfg, device="cpu")
    c.fit(Xf, n_epochs=2, seed=5, holdout=hold, workspace=ws, resume=True)
    trace_bc = ([h["holdout_objective"] for h in b.history_]
                + [h["holdout_objective"] for h in c.history_])
    assert len(b.history_) == 3 and len(trace_bc) == len(trace_a)
    np.testing.assert_allclose(trace_bc, trace_a, rtol=1e-4)
    np.testing.assert_allclose(c.D_.numpy(), a.D_.numpy(), atol=2e-4)
    assert int(c.state.step) == int(a.state.step) == 12
    assert len(ws.read_metrics()) == 6


def test_learner_options(rng):
    with pytest.raises(TypeError, match="Mesh"):
        lt.OnlineDictionaryLearner(mesh=object())
    mesh = lt.parallel.make_mesh(devices=["cpu"] * 2)
    assert lt.OnlineDictionaryLearner(mesh=mesh).mesh is mesh
    learner = lt.OnlineDictionaryLearner(lt.OnlineDLConfig(K=8))
    assert learner._resolve_cold_unroll() == 0
    learner.cfg = lt.OnlineDLConfig(K=8, fs_cold_unroll=6)
    assert learner._resolve_cold_unroll() == 6
    with pytest.raises(ValueError, match="batch_size"):
        lt.OnlineDictionaryLearner(lt.OnlineDLConfig(K=8, batch_size=64),
                                   device="cpu").fit(_data(rng, 32))


def test_partial_fit_on_the_cpu_launches_no_kernel(rng):
    lt.reset_launch_counts()
    Xf = _data(rng, 64)
    lt.OnlineDictionaryLearner(lt.OnlineDLConfig(K=24, lam=LAM),
                               device="cpu").partial_fit(Xf)
    assert not any(lt.launch_counts().values())


def test_online_state_from_reference_round_trips(rng):
    D = rng.standard_normal((16, 24))
    st = online_state_from_reference(D, np.eye(24), np.ones((16, 24)),
                                     np.int32(5), device="cpu")
    assert isinstance(st, lt.OnlineDLState)
    assert st.D.dtype == torch.float32 and int(st.step) == 5
    np.testing.assert_allclose(st.D.numpy(), D, atol=1e-6)
    assert torch.equal(st.A, torch.eye(24))
