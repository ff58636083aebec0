"""The port's K-SVD (atom sweeps, atom bookkeeping, the learner) against
lyssandra_tpu and the fp64 oracle: the same float32 inputs from a numpy
seed go through both packages on the CPU, and dictionaries and codes are
carried across as numpy arrays."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lyssandra_tpu_torch as lt
from lyssandra_tpu import oracle
from lyssandra_tpu.config import KSVDConfig as JKSVDConfig
from lyssandra_tpu.ops import dictionaries as jdict
from lyssandra_tpu.solvers import batch_omp as j_batch_omp
from lyssandra_tpu.solvers.greedy import GreedyResult as JGreedyResult
from lyssandra_tpu.utils import Workspace as JWorkspace
from lyssandra_tpu_torch.ops import dictionaries as tdict
from lyssandra_tpu_torch.solvers.greedy import GreedyResult
from tests.conftest import make_problem

# the modules, not the classes their packages re-export under that name
jksvd = importlib.import_module("lyssandra_tpu.dict_learning.ksvd")
tksvd = importlib.import_module("lyssandra_tpu_torch.dict_learning.ksvd")

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _sweep_problem(rng, N=120, K=24, T=3):
    D, X, _ = make_problem(rng, p=16, K=K, N=N, T=T)
    return D, X, oracle.batch_omp(D, X, T)


def _objective(X, D, G):
    R = np.asarray(X, np.float64) - np.asarray(D, np.float64) @ np.asarray(
        G, np.float64)
    return float((R * R).sum())


# ---- the dense sweep -----------------------------------------------------

def test_atom_update_b1_matches_jax_and_oracle(rng):
    # B=1 is the oracle's sequential Gauss-Seidel order; the reference's own
    # tolerances (tests/test_dict_learning.py): D 2e-4, Gamma 2e-3
    D, X, G = _sweep_problem(rng)
    Dt, Gt = tksvd.ksvd_atom_update(_t(X), _t(D), _t(G), exact=False,
                                    atom_block=1)
    Dj, Gj = jksvd.ksvd_atom_update(_j(X), _j(D), _j(G), exact=False,
                                    atom_block=1)
    Dr, Gr = oracle.ksvd_atom_update(X, D, G, exact=False)
    for Dw, Gw in ((np.asarray(Dj), np.asarray(Gj)), (Dr, Gr)):
        np.testing.assert_allclose(Dt.numpy(), Dw, atol=2e-4)
        np.testing.assert_allclose(Gt.numpy(), Gw, atol=2e-3)


def test_atom_update_exact_matches_jax_and_oracle(rng):
    # power-iterated rank-1 SVD: D against JAX within 1e-4, the objective
    # against the oracle's exact SVD within rtol 1e-3 (singular vectors may
    # flip sign, so the oracle is held by objective)
    D, X, G = _sweep_problem(rng)
    Dt, Gt = tksvd.ksvd_atom_update(_t(X), _t(D), _t(G), exact=True,
                                    svd_iters=5)
    Dj, _ = jksvd.ksvd_atom_update(_j(X), _j(D), _j(G), exact=True,
                                   svd_iters=5)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), atol=1e-4)
    Dr, Gr = oracle.ksvd_atom_update(X, D, G, exact=True)
    err = _objective(X, Dt.numpy(), Gt.numpy())
    assert err <= _objective(X, D, G) + 1e-6
    np.testing.assert_allclose(err, _objective(X, Dr, Gr), rtol=1e-3)


@pytest.mark.parametrize("B", [4, 8, 16])
def test_atom_update_block_matches_jax(rng, B):
    # Jacobi within a block of B atoms: the same recursion as the reference
    # (D 2e-4, Gamma 2e-3), supports kept, unit-norm atoms, and the
    # objective falls.  At K=24, B=16 shrinks to 12 (the largest divisor
    # of K), as in the reference
    D, X, _ = make_problem(rng, p=16, K=24, N=400, T=4)
    G = oracle.batch_omp(D, X, 4)
    Dt, Gt = tksvd.ksvd_atom_update(_t(X), _t(D), _t(G), atom_block=B)
    Dj, Gj = jksvd.ksvd_atom_update(_j(X), _j(D), _j(G), atom_block=B)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), atol=2e-4)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), atol=2e-3)
    assert (Gt.numpy()[G == 0] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(Dt.numpy(), axis=0), 1.0,
                               atol=1e-4)
    assert _objective(X, Dt.numpy(), Gt.numpy()) < _objective(X, D, G)


def test_atom_update_keeps_inputs_and_unused_atoms(rng):
    # the sweep is functional (its inputs are cloned), and an atom with no
    # users keeps its atom and its (zero) row
    D, X, G = _sweep_problem(rng)
    G[5] = 0.0
    Xt, Dt0, Gt0 = _t(X), _t(D), _t(G)
    copies = [a.clone() for a in (Xt, Dt0, Gt0)]
    Dt, Gt = tksvd.ksvd_atom_update(Xt, Dt0, Gt0)
    for a, b in zip((Xt, Dt0, Gt0), copies):
        assert torch.equal(a, b)
    assert torch.equal(Dt[:, 5], Dt0[:, 5]) and not Gt[5].any()


# ---- the compact sweep ---------------------------------------------------

def _compact_problem(rng):
    """JAX Batch-OMP codes (compact) of a well-posed problem, with lane 0
    made to pick atom idx[0, 0] twice with nonzero coefficients (the case
    the duplicate-slot merge exists for)."""
    D, X, _ = make_problem(rng, p=16, K=24, N=200, T=4, dtype=np.float32)
    res = j_batch_omp(_j(D), _j(X), 4, dense=False)
    idx = np.array(res.idx)
    gamma = np.array(res.gamma)
    idx[0, 2] = idx[0, 0]
    gamma[0, 2] = 0.3
    return D, X, idx, gamma, res


def test_atom_update_compact_matches_jax(rng):
    D, X, idx, gamma, _ = _compact_problem(rng)
    Dj, gj, nj = jksvd.ksvd_atom_update_compact(
        _j(X), _j(D), jnp.asarray(idx), _j(gamma), atom_block=8)
    Dt, gt, nt = tksvd.ksvd_atom_update_compact(
        _t(X), _t(D), torch.from_numpy(idx), _t(gamma), atom_block=8)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), atol=2e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-4)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    # the duplicate slot was merged into the first and zeroed
    assert gt[0, 2] == 0 and gt[0, 0] != 0


def test_atom_update_compact_matches_dense_block(rng):
    # the compact sweep is the dense block sweep with the block rows made
    # from the triplets (tests/test_dict_learning.py's check, in the port)
    D, X, _, _, res = _compact_problem(rng)
    idx, gamma = torch.from_numpy(np.array(res.idx)), _t(res.gamma)
    codes = GreedyResult(idx, gamma, _t(res.err),
                         torch.from_numpy(np.array(res.nsel)))
    G = codes.dense(24)
    Dd, Gd = tksvd.ksvd_atom_update(_t(X), _t(D), G, atom_block=8)
    Dc, gc, nusers = tksvd.ksvd_atom_update_compact(_t(X), _t(D), idx,
                                                    gamma, atom_block=8)
    np.testing.assert_allclose(Dc.numpy(), Dd.numpy(), atol=2e-5)
    np.testing.assert_array_equal(nusers.numpy(),
                                  (G.abs() > 0).sum(dim=1).numpy())
    Gc = GreedyResult(idx, gc, codes.err, codes.nsel).dense(24)
    np.testing.assert_allclose(Gc.numpy(), Gd.numpy(), atol=2e-4)


def test_compact_post_matches_jax(rng):
    # the compact iteration's tail (sweep, stats, replacement) with dead
    # atoms, so that the replacement runs
    D, X, idx, gamma, res = _compact_problem(rng)
    keep = ~np.isin(idx, [2, 9])
    gamma = np.where(keep, gamma, 0.0).astype(np.float32)
    kw = dict(exact=False, svd_iters=3, atom_block=8, replace_dead=True,
              min_use=1, max_coherence=0.99)
    Dj, gj, ej, sj = jksvd._ksvd_compact_post(
        _j(X), _j(D), jnp.asarray(idx), _j(gamma), res.err, **kw)
    Dt, gt, et, st = tksvd._ksvd_compact_post(
        _t(X), _t(D), torch.from_numpy(idx), _t(gamma), _t(res.err), **kw)
    assert float(st[3]) == float(sj[3]) >= 2
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), atol=2e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-4)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4)


# ---- atom bookkeeping ----------------------------------------------------

def test_replace_coherent_pairs_matches_jax(rng):
    # the upper-triangle flag: of the pairs (3, 7) and (12, 15) only the
    # lower index is replaced (min_use=0 isolates the coherence rule)
    D, X, _ = make_problem(rng, p=16, K=24, N=200, T=3)
    D[:, 7] = D[:, 3]
    D[:, 15] = -D[:, 12]
    G = oracle.batch_omp(D, X, 3)
    Dj, bj = jdict.replace_unused_atoms(_j(X), _j(D), _j(G), min_use=0,
                                        return_mask=True)
    Dt, bt = tdict.replace_unused_atoms(_t(X), _t(D), _t(G), min_use=0,
                                        return_mask=True)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert bt[3] and not bt[7] and bt[12] and not bt[15]
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), atol=1e-6)
    np.testing.assert_array_equal(
        bt.numpy(), np.abs(oracle.replace_unused_atoms(X, D, G, min_use=0)
                           - D).max(axis=0) > 1e-9)


def test_replace_on_duplicated_data_matches_jax(rng):
    # every signal twice: the errors tie in pairs, and the lower index must
    # come first (lax.top_k's order), so both packages take the same columns
    D, X, _ = make_problem(rng, p=16, K=24, N=150, T=3)
    X = np.concatenate([X, X], axis=1)
    G = oracle.batch_omp(D, X, 3)
    G[[0, 5, 9, 17]] = 0.0                 # four dead atoms
    Dj, bj = jdict.replace_unused_atoms(_j(X), _j(D), _j(G),
                                        return_mask=True)
    Dt, bt = tdict.replace_unused_atoms(_t(X), _t(D), _t(G),
                                        return_mask=True)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert bt[[0, 5, 9, 17]].all()
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), atol=1e-6)


def test_worst_first_breaks_ties_to_the_lower_index():
    err = torch.tensor([1.0, 3.0, 2.0, 3.0, 3.0, 0.5])
    assert tdict.worst_first(err, 4).tolist() == [1, 3, 4, 2]
    assert tdict.worst_first(err, 9).tolist() == [1, 3, 4, 2, 0, 5]


def test_mutual_coherence_matches_jax(rng):
    D = rng.standard_normal((16, 40))
    D /= np.linalg.norm(D, axis=0)
    D[:, 11] = -D[:, 30]
    got = float(tdict.mutual_coherence(_t(D)))
    assert got == pytest.approx(float(jdict.mutual_coherence(_j(D))),
                                abs=1e-6)
    assert got == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("p,K", [(64, 256), (192, 256), (256, 144), (128, 64)],
                         ids=["grey", "colour3", "colour4", "colour2"])
def test_init_dictionary_dct_equals_reference(p, K):
    X = np.zeros((p, 5), np.float32)
    got = lt.init_dictionary(X, K, "dct", device="cpu")
    want = np.asarray(jdict.init_dictionary(_j(X), K, "dct"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_dictionary_dct_rejects_other_dims():
    with pytest.raises(ValueError, match="not p"):
        lt.init_dictionary(np.zeros((17, 3)), 16, "dct", device="cpu")


def test_init_dictionary_data_semantics(rng):
    X = rng.standard_normal((16, 100)).astype(np.float32)
    D = lt.init_dictionary(X, 40, "data", seed=3, device="cpu")
    assert D.shape == (16, 40) and D.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(D, dim=0).numpy(), 1.0,
                               atol=1e-6)
    # each atom is a normalized column of X, distinct while N >= K
    Xn = X / np.linalg.norm(X, axis=0)
    match = np.abs(D.numpy().T @ Xn) > 1 - 1e-6            # (K, N)
    assert (match.sum(axis=1) == 1).all()
    assert len(set(match.argmax(axis=1).tolist())) == 40
    # the same seed gives the same D, another seed another D
    assert torch.equal(D, lt.init_dictionary(X, 40, "data", seed=3,
                                             device="cpu"))
    assert not torch.equal(D, lt.init_dictionary(X, 40, "data", seed=4,
                                                 device="cpu"))
    # N < K draws with replacement
    Ds = lt.init_dictionary(X[:, :10], 30, "data", device="cpu")
    assert Ds.shape == (16, 30)
    assert (np.abs(Ds.numpy().T @ Xn[:, :10]).max(axis=1) > 1 - 1e-6).all()


def test_init_dictionary_data_replaces_zero_columns(rng):
    X = np.zeros((16, 50), np.float32)
    X[:, ::5] = rng.standard_normal((16, 10))
    D = lt.init_dictionary(X, 30, "data", device="cpu")
    assert torch.isfinite(D).all()
    np.testing.assert_allclose(torch.linalg.norm(D, dim=0).numpy(), 1.0,
                               atol=1e-6)
    Xn = X[:, ::5] / np.linalg.norm(X[:, ::5], axis=0)
    from_data = np.abs(D.numpy().T @ Xn).max(axis=1) > 1 - 1e-6
    # 10 of 50 columns are nonzero: most atoms are the Gaussian fallback
    assert 0 < from_data.sum() < 30


def test_init_dictionary_random_and_errors(rng):
    X = torch.from_numpy(rng.standard_normal((12, 30)).astype(np.float32))
    D = lt.init_dictionary(X, 20, "random", seed=1)     # CPU tensor: CPU
    assert D.device.type == "cpu" and D.shape == (12, 20)
    np.testing.assert_allclose(torch.linalg.norm(D, dim=0).numpy(), 1.0,
                               atol=1e-6)
    assert torch.equal(D, lt.init_dictionary(X, 20, "random", seed=1))
    with pytest.raises(ValueError):
        lt.init_dictionary(X, 20, "pca")


# ---- the learner ---------------------------------------------------------

def _fit_problem(rng):
    D, X, _ = make_problem(rng, p=16, K=24, N=300, T=3)
    D0 = rng.standard_normal((16, 24))
    D0 /= np.linalg.norm(D0, axis=0)
    return X.astype(np.float32), D0.astype(np.float32)


@pytest.mark.parametrize("codes", ["dense", "compact"])
def test_learner_matches_jax(rng, codes):
    # from a shared D0 (init draws cannot match across PRNGs): iteration
    # 0's objective within rtol 1e-4, every later one within 2%, the same
    # history keys
    X, D0 = _fit_problem(rng)
    cfg = dict(K=24, T=3, n_iter=5, codes=codes, seed=0)
    a = jksvd.KSVDLearner(JKSVDConfig(**cfg)).fit(X, D0=D0)
    b = lt.KSVDLearner(lt.KSVDConfig(**cfg), device="cpu").fit(X, D0=D0)
    oa = [h["objective"] for h in a.history_]
    ob = [h["objective"] for h in b.history_]
    assert len(ob) == 5
    np.testing.assert_allclose(ob[0], oa[0], rtol=1e-4)
    np.testing.assert_allclose(ob, oa, rtol=0.02)
    assert [sorted(h) for h in b.history_] == [sorted(h) for h in a.history_]
    assert ob[-1] < ob[0]
    np.testing.assert_allclose(torch.linalg.norm(b.D_, dim=0).numpy(), 1.0,
                               atol=1e-4)
    if codes == "compact":
        assert isinstance(b.Gamma_, GreedyResult)
        assert isinstance(a.Gamma_, JGreedyResult)
        np.testing.assert_allclose(b.Gamma_.to_csc(24).toarray(),
                                   b.Gamma_.dense(24).numpy(), atol=1e-6)
    else:
        assert tuple(b.Gamma_.shape) == (24, 300)


def test_learner_replacement_matches_jax(rng):
    # duplicated data (tests/test_dict_learning.py's churn case) from a
    # shared D0 with four copies of one atom: the replacement runs, the
    # objectives follow the reference within 2% and the counts settle
    D, X, _ = make_problem(rng, p=16, K=32, N=150, T=3)
    X = np.concatenate([X, X], axis=1).astype(np.float32)
    D0 = rng.standard_normal((16, 32))
    D0[:, 1:4] = D0[:, :1]
    D0 = (D0 / np.linalg.norm(D0, axis=0)).astype(np.float32)
    cfg = dict(K=32, T=3, n_iter=6, replace_dead=True, seed=0)
    a = jksvd.KSVDLearner(JKSVDConfig(**cfg)).fit(X, D0=D0)
    b = lt.KSVDLearner(lt.KSVDConfig(**cfg), device="cpu").fit(X, D0=D0)
    ra = [h["atoms_replaced"] for h in a.history_]
    rb = [h["atoms_replaced"] for h in b.history_]
    assert rb[0] == ra[0] >= 3
    assert rb[-1] <= max(2, rb[0] // 4), rb
    np.testing.assert_allclose([h["objective"] for h in b.history_],
                               [h["objective"] for h in a.history_],
                               rtol=0.02)
    for h in b.history_:
        assert h["objective"] <= h["objective_coding"] * 1.001


def test_learner_leaves_inputs_and_encodes(rng):
    X, D0 = _fit_problem(rng)
    Xt, D0t = torch.from_numpy(X.copy()), torch.from_numpy(D0.copy())
    learner = lt.KSVDLearner(lt.KSVDConfig(K=24, T=3, n_iter=2)).fit(
        Xt, D0=D0t)
    assert torch.equal(Xt, torch.from_numpy(X))
    assert torch.equal(D0t, torch.from_numpy(D0))
    assert learner.D_.device.type == "cpu"
    G = learner.encode(X)
    want = lt.SparseEncoder("bomp", {"T": 3}, check_atoms=False).encode(
        Xt, learner.D_)
    assert torch.equal(G, want)
    assert isinstance(learner.encode(X, dense=False), GreedyResult)


def test_learner_eager_metrics(rng):
    # a callback asks for each iteration's metrics as it ends (the eager
    # fetch): the reference's per-iteration keys, in order
    X, D0 = _fit_problem(rng)
    seen = []
    cfg = dict(K=24, T=3, n_iter=3)
    b = lt.KSVDLearner(lt.KSVDConfig(**cfg), device="cpu",
                       callback=lambda it, m: seen.append(it)).fit(X, D0=D0)
    a = jksvd.KSVDLearner(JKSVDConfig(**cfg), callback=lambda it, m: None
                          ).fit(X, D0=D0)
    assert seen == [0, 1, 2]
    assert [sorted(h) for h in b.history_] == [sorted(h) for h in a.history_]
    assert "dispatch_seconds" not in b.history_[0]
    lazy = lt.KSVDLearner(lt.KSVDConfig(**cfg), device="cpu").fit(X, D0=D0)
    np.testing.assert_allclose([h["objective"] for h in b.history_],
                               [h["objective"] for h in lazy.history_],
                               rtol=1e-6)


def test_learner_auto_codes_pick_dense_at_small_size(rng, monkeypatch):
    # 'auto' takes compact codes only when a dense Gamma passes 1 GiB
    X, D0 = _fit_problem(rng)
    calls = []
    real = tksvd.ksvd_step_compact
    monkeypatch.setattr(tksvd, "ksvd_step_compact",
                        lambda *a: calls.append(1) or real(*a))
    lt.KSVDLearner(lt.KSVDConfig(K=24, T=3, n_iter=1)).fit(
        torch.from_numpy(X), D0=D0)
    assert not calls
    lt.KSVDLearner(lt.KSVDConfig(K=24, T=3, n_iter=1, codes="compact")).fit(
        torch.from_numpy(X), D0=D0)
    assert calls


def test_checkpoint_resume(rng, tmp_path):
    # tests/test_dict_learning.py::test_ksvd_checkpoint_resume in the port
    D, X, _ = make_problem(rng, p=16, K=24, N=200, T=3)
    X = torch.from_numpy(X.astype(np.float32))
    cfg = lt.KSVDConfig(K=24, T=3, n_iter=4, replace_dead=False, seed=0)
    ws = lt.Workspace(str(tmp_path / "run"))
    a = lt.KSVDLearner(cfg, workspace=ws, checkpoint_every=2).fit(X)
    b = lt.KSVDLearner(cfg, workspace=ws, checkpoint_every=2)
    b.fit(X, resume=True)
    assert len(b.history_) == 0                 # nothing left to do
    np.testing.assert_allclose(b.D_.numpy(), a.D_.numpy(), atol=1e-6)
    assert tuple(b.Gamma_.shape) == (24, 200)   # re-coded once
    assert [m["iter"] for m in ws.read_metrics()] == [0, 1, 2, 3]
    ws2 = lt.Workspace(str(tmp_path / "run2"))
    c = lt.KSVDLearner(cfg, workspace=ws2, checkpoint_every=2)
    c.fit(X, n_iter=2)
    d = lt.KSVDLearner(cfg, workspace=ws2, checkpoint_every=2)
    d.fit(X, resume=True)
    assert [h["iter"] for h in d.history_] == [2, 3]
    # the resumed fit is the uninterrupted one
    np.testing.assert_allclose(d.D_.numpy(), a.D_.numpy(), atol=1e-5)


def test_checkpoints_are_not_the_reference_format(rng, tmp_path):
    # the .npz arrays are shared; checkpoints are torch.save files that the
    # reference's Orbax manager does not list
    ws = lt.Workspace(str(tmp_path / "w"))
    ws.save_state(3, {"D": torch.ones(4, 2), "iter": torch.tensor(3)})
    assert JWorkspace(str(tmp_path / "w")).load_latest_state() == (None,
                                                                    None)


def test_mesh_not_ported():
    # a mesh that is not a Mesh raises TypeError; a CPU mesh is taken and
    # handed to the default encoder
    with pytest.raises(TypeError, match="Mesh"):
        lt.KSVDLearner(lt.KSVDConfig(), mesh=object())
    from lyssandra_tpu_torch.apps import denoise_adaptive

    with pytest.raises(TypeError, match="Mesh"):
        denoise_adaptive(np.zeros((16, 16)), 20.0, mesh=object(),
                         device="cpu")
    mesh = lt.parallel.make_mesh(devices=["cpu"] * 2)
    learner = lt.KSVDLearner(lt.KSVDConfig(), mesh=mesh)
    assert learner.encoder.mesh is mesh
    assert learner.device == torch.device("cpu")


def test_ksvd_alias_and_config_replace():
    assert lt.ksvd is lt.KSVDLearner
    cfg = dataclasses.replace(lt.KSVDConfig(), atom_block=8)
    assert cfg.atom_block == 8 and lt.KSVDConfig().atom_block == 1
