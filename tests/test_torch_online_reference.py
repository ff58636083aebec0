"""The online learner against the benchmark's plain reference
(``portbench/reference/online.py``, float64, no import of the port) on
the CPU at a small size: p = 12, K = 24, minibatches of 64 unit-norm
signals.  The codes are held by their objective against the reference's
lasso optimum and by the KKT conditions, A and B from the program's codes,
the sweep atom by atom from the program's own D, A and B; ``fit`` and
``partial_fit`` go through ``minibatch_update`` once a minibatch."""

import importlib

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu import oracle
from portbench.reference import online as ref
from tests.conftest import make_problem

tonline = importlib.import_module("lyssandra_tpu_torch.dict_learning.online")

torch.set_num_threads(1)

LAM = 0.15
P, K, BS = 12, 24, 64
CFG = lt.OnlineDLConfig(K=K, lam=LAM, batch_size=BS, chunk_batches=2,
                        code_blocks=2, seed=0)


def _signals(rng, n):
    """n unit-norm columns of 3-sparse combinations over a random D."""
    _, X, _ = make_problem(rng, p=P, K=K, N=n, T=3)
    X = X / np.linalg.norm(X, axis=0, keepdims=True)
    return torch.from_numpy(X.astype(np.float32))


def _dictionary(rng):
    D = rng.standard_normal((P, K))
    return torch.from_numpy((D / np.linalg.norm(D, axis=0)).astype(
        np.float32))


def _d(*ts):
    return [t.double() for t in ts]


def _code_numbers(D, X, Gamma):
    """(widest relative objective gap to the reference optimum, widest
    KKT breach over lam) of the program's codes."""
    D, X, Gamma = _d(D, X, Gamma)
    G_ref, done = ref.lasso(D, X, LAM)
    assert bool(done.all())
    f_ref = ref.objective(D, X, G_ref, LAM)
    gap = (ref.objective(D, X, Gamma, LAM) - f_ref) / f_ref
    return float(gap.max()), float(ref.kkt(D, X, Gamma, LAM).max())


class Recorder:
    """Wraps ``minibatch_update``: keeps (D, A, B, Xb) in and
    (D, A, B, Gamma) out of each call."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = tonline.minibatch_update

        def wrapped(D, A, B, Xb, *a, **kw):
            out = real(D, A, B, Xb, *a, **kw)
            self.calls.append((D, A, B, Xb) + tuple(out))
            return out

        monkeypatch.setattr(tonline, "minibatch_update", wrapped)


def _minibatch_gaps(rec):
    """(stats gap, widest atom gap) of one recorded minibatch against the
    reference from the program's own inputs and codes."""
    D, A, B, Xb, Dn, An, Bn, Gamma = _d(*rec)
    A_ref, B_ref = ref.statistics(A, B, Xb, Gamma, 1.0)
    stats = max(float((An - A_ref).abs().max() / A_ref.abs().max()),
                float((Bn - B_ref).abs().max() / B_ref.abs().max()))
    atoms = torch.linalg.vector_norm(Dn - ref.sweep(D, An, Bn), dim=0)
    return stats, float(atoms.max())


def test_reference_lasso_meets_the_oracle_and_its_kkt(rng):
    # the reference's feature-sign against the float64 oracle's, lane by
    # lane: the same objectives, and the optimality conditions to 1e-9
    D, X, _ = make_problem(rng, p=P, K=K, N=48, T=3)
    X = X / np.linalg.norm(X, axis=0, keepdims=True)
    G, done = ref.lasso(torch.from_numpy(D), torch.from_numpy(X), LAM)
    assert bool(done.all())
    want = oracle.lasso(D, X, LAM)
    f = ref.objective(torch.from_numpy(D), torch.from_numpy(X), G, LAM)
    fw = ref.objective(torch.from_numpy(D), torch.from_numpy(X),
                       torch.from_numpy(want), LAM)
    np.testing.assert_allclose(f.numpy(), fw.numpy(), rtol=1e-10)
    assert float(ref.kkt(torch.from_numpy(D), torch.from_numpy(X), G,
                         LAM).max()) < 1e-9


def test_reference_lasso_keeps_duplicate_atoms_finite(rng):
    # a dictionary with an atom repeated (config 4's data dictionaries
    # have coherence 1): the reference still ends every lane at the KKT
    D = _dictionary(rng).double()
    D[:, 5] = D[:, 4]
    X = _signals(rng, 32).double()
    G, done = ref.lasso(D, X, LAM)
    assert bool(done.all()) and bool(torch.isfinite(G).all())
    assert float(ref.kkt(D, X, G, LAM).max()) < 1e-8


@pytest.mark.parametrize("coder", ["feature_sign", "feature_sign_scan"])
def test_codes_by_objective_and_kkt(rng, coder):
    D, X = _dictionary(rng), _signals(rng, BS)
    if coder == "feature_sign":
        G = lt.feature_sign(D, X, LAM, device="cpu")
    else:
        G = tonline.feature_sign_scan(D, X, LAM)
    gap, kkt = _code_numbers(D, X, G)
    assert -1e-9 < gap < 1e-5 and kkt < 1e-3, (gap, kkt)


def test_statistics_and_sweep_against_the_reference(rng, monkeypatch):
    # one step of partial_fit's route: A and B to float32 rounding, the
    # swept atoms within 1e-5 of the float64 sweep from the same inputs
    rec = Recorder(monkeypatch)
    state = tonline.OnlineDLState(
        _dictionary(rng), torch.eye(K) * 0.5, torch.zeros(P, K),
        torch.zeros((), dtype=torch.int32))
    lt.online_dl_step(state, _signals(rng, BS), CFG)
    assert len(rec.calls) == 1
    stats, atoms = _minibatch_gaps(rec.calls[0])
    assert stats < 1e-6 and atoms < 1e-5, (stats, atoms)
    gap, kkt = _code_numbers(rec.calls[0][0], rec.calls[0][3],
                             rec.calls[0][7])
    assert gap < 1e-5 and kkt < 1e-3


@pytest.mark.parametrize("route", ["fit", "partial_fit"])
def test_learner_goes_through_minibatch_update_once_a_minibatch(
        rng, monkeypatch, route):
    # two minibatches either way: fit (one chunk) or two partial_fits,
    # each minibatch's step held against the reference, the learner's
    # state the last step's, its batch objective the reference's
    X = _signals(rng, 2 * BS)
    rec = Recorder(monkeypatch)
    learner = lt.OnlineDictionaryLearner(CFG, device="cpu")
    if route == "fit":
        learner.fit(X, seed=4)
        perm = np.random.default_rng(4).permutation(2 * BS)
        want = [X[:, perm[j * BS:(j + 1) * BS]] for j in range(2)]
    else:
        want = [X[:, :BS], X[:, BS:]]
        for Xb in want:
            learner.partial_fit(Xb)
    assert len(rec.calls) == 2 and int(learner.state.step) == 2
    for r, Xb in zip(rec.calls, want):
        assert torch.equal(r[3], Xb)
        stats, atoms = _minibatch_gaps(r)
        gap, kkt = _code_numbers(r[0], r[3], r[7])
        assert stats < 1e-6 and atoms < 1e-5 and gap < 1e-5 and kkt < 1e-3
    assert all(torch.equal(a, b) for a, b in zip(rec.calls[1][:3],
                                                  rec.calls[0][4:7]))
    assert all(torch.equal(a, b) for a, b in zip(learner.state[:3],
                                                  rec.calls[1][4:7]))
    D, Xb, Gamma = _d(learner.D_, want[1], rec.calls[1][7])
    f = float(ref.objective(D, Xb, Gamma, LAM).sum())
    np.testing.assert_allclose(learner.history_[-1]["batch_objective"], f,
                               rtol=1e-5)


def test_holdout_objective_against_the_reference(rng):
    D, X = _dictionary(rng), _signals(rng, 48)
    got = float(tonline.holdout_objective(D, X, LAM))
    want = float(ref.holdout_objective(D.double(), X.double(), LAM, 300))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_planted_sweep_without_projection_fails(rng, monkeypatch):
    # the sweep with its projection onto the unit ball taken out: the
    # atom gaps the benchmark's check reads come out far above 1e-5
    def no_projection(D, A, B, n_sweeps):
        D = D.clone()
        akk = torch.diagonal(A).clamp_min(1e-10)
        for _ in range(n_sweeps):
            for k in range(D.shape[1]):
                D[:, k] = D[:, k] + torch.addmv(B[:, k], D, A[:, k],
                                                alpha=-1.0) / akk[k]
        return D

    monkeypatch.setattr(tonline, "_dict_update_body", no_projection)
    rec = Recorder(monkeypatch)
    learner = lt.OnlineDictionaryLearner(CFG, device="cpu")
    learner.partial_fit(_signals(rng, BS))
    _, atoms = _minibatch_gaps(rec.calls[0])
    assert atoms > 1e-3, atoms
