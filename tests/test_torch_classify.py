"""The port's classifiers (LC-KSVD, SRC, the linear heads) against
lyssandra_tpu and the fp64 oracle on the CPU: the same float32 inputs from
a numpy seed, learned state carried across as numpy arrays, and both
packages end to end on a reduced run of sklearn's digits."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lyssandra_tpu_torch as lt
from lyssandra_tpu import oracle
from lyssandra_tpu.classify import LCKSVD as JLCKSVD
from lyssandra_tpu.classify import LinearClassifier as JLinearClassifier
from lyssandra_tpu.classify import LinearSVM as JLinearSVM
from lyssandra_tpu.classify import SRCClassifier as JSRC
from lyssandra_tpu.config import LCKSVDConfig as JLCKSVDConfig
from lyssandra_tpu.solvers import SparseEncoder as JSparseEncoder
from lyssandra_tpu_torch.classify import one_hot, ridge
from lyssandra_tpu_torch.utils.interop import (
    lcksvd_from_reference,
    src_from_reference,
)

jlc = importlib.import_module("lyssandra_tpu.classify.lc_ksvd")
tlc = importlib.import_module("lyssandra_tpu_torch.classify.lc_ksvd")
jlin = importlib.import_module("lyssandra_tpu.classify.linear")

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _digits_like(rng, C=4, per=30, p=32, noise=0.25, protos=None):
    """tests/test_classify.py's toy set: C class prototypes plus noise,
    unit-normalized; pass ``protos`` to draw train and test alike."""
    if protos is None:
        protos = rng.standard_normal((p, C))
    X = np.concatenate([protos[:, [c]] + noise * rng.standard_normal(
        (p, per)) for c in range(C)], axis=1)
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    return X.astype(np.float32), np.repeat(np.arange(C), per), protos


# ---- the linear heads ----------------------------------------------------

@pytest.mark.parametrize("K,C", [(10, 3), (12, 4), (7, 7)])
def test_one_hot_and_label_consistency_match(rng, K, C):
    y = rng.integers(0, C, 25)
    y[:C] = np.arange(C)
    H = one_hot(y, C, device="cpu")
    assert H.dtype == torch.float32 and H.shape == (C, 25)
    np.testing.assert_array_equal(H.numpy(), oracle.one_hot(y, C))
    np.testing.assert_array_equal(H.numpy(), np.asarray(jlin.one_hot(y, C)))
    Q = tlc.build_label_consistency(y, K, C, device="cpu")
    np.testing.assert_array_equal(Q.numpy(),
                                  oracle.build_label_consistency(y, K, C))
    np.testing.assert_array_equal(
        Q.numpy(), np.asarray(jlc.build_label_consistency(y, K, C)))


@pytest.mark.parametrize("lam", [1.0, 0.1])
def test_ridge_matches_jax_and_oracle(rng, lam):
    # the reference's tolerance against the oracle, 1e-4
    Z = rng.standard_normal((16, 40))
    Y = rng.standard_normal((3, 40))
    got = ridge(_t(Z), _t(Y), lam).numpy()
    np.testing.assert_allclose(got, oracle.ridge(Z, Y, lam), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jlin.ridge(_j(Z), _j(Y), lam)),
                               atol=1e-5)


def test_linear_classifier_matches_jax(rng):
    X, y, _ = _digits_like(rng)
    got = lt.LinearClassifier(lam=0.1, device="cpu").fit(X, y)
    want = JLinearClassifier(lam=0.1).fit(X, y)
    np.testing.assert_allclose(got.W_.numpy(), np.asarray(want.W_),
                               atol=1e-5)
    assert got.classes_ == 4 and got.score(X, y) > 0.95
    np.testing.assert_array_equal(got.predict(X).numpy(),
                                  np.asarray(want.predict(X)))


@pytest.mark.parametrize("intercept", [True, False])
def test_linear_svm_matches_jax(rng, intercept):
    # 300 Nesterov steps with the reference's step size: W within 1e-4 of
    # the reference's (it carries the momentum scalar in float32 as well)
    X, y, _ = _digits_like(rng, C=3, per=40, noise=0.6)
    got = lt.LinearSVM(C=2.0, fit_intercept=intercept, device="cpu").fit(X, y)
    want = JLinearSVM(C=2.0, fit_intercept=intercept).fit(X, y)
    assert got.W_.shape == (3, 32 + intercept)
    np.testing.assert_allclose(got.W_.numpy(), np.asarray(want.W_),
                               atol=1e-4)
    np.testing.assert_array_equal(got.predict(X).numpy(),
                                  np.asarray(want.predict(X)))
    assert got.score(X, y) == pytest.approx(want.score(X, y))
    fixed = lt.LinearSVM(lr=0.05, n_iter=20, device="cpu").fit(X, y)
    np.testing.assert_allclose(
        fixed.W_.numpy(), np.asarray(JLinearSVM(lr=0.05, n_iter=20).fit(
            X, y).W_), atol=1e-5)


# ---- LC-KSVD -------------------------------------------------------------

def test_ksvd_init_scan_matches_jax(rng):
    # the per-class init fits from the same D0s and zero-padded class
    # signals (3 classes of 20, 17 and 11 signals): atoms within 1e-4
    X, y, _ = _digits_like(rng, C=3, per=20, p=16)
    counts = [20, 17, 11]
    Xs = np.zeros((3, 16, 20), np.float32)
    for c, n in enumerate(counts):
        Xs[c, :, :n] = X[:, y == c][:, :n]
    D0s = rng.standard_normal((3, 16, 6))
    D0s /= np.linalg.norm(D0s, axis=1, keepdims=True)
    got = tlc._ksvd_init_scan(_t(Xs), _t(D0s), T=3, n_iter=4)
    want = jlc._ksvd_init_scan(_j(Xs), _j(D0s), T=3, n_iter=4)
    assert got.shape == (3, 16, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)


def _carried_lcksvd(rng):
    Xtr, ytr, protos = _digits_like(rng, C=3, per=40)
    Xte, yte, _ = _digits_like(rng, C=3, per=15, protos=protos)
    j = JLCKSVD(JLCKSVDConfig(K=24, T=4, n_iter=3)).fit(Xtr, ytr)
    t = lcksvd_from_reference(np.asarray(j.D_), np.asarray(j.A_),
                              np.asarray(j.W_), j.C_,
                              dataclasses.asdict(j.cfg), device="cpu")
    return j, t, Xtr, ytr, Xte, yte


def test_lcksvd_predicts_as_jax_from_a_carried_state(rng):
    # the codes of a carried-across D (OMP, T=4) and the decision values
    # within 1e-4; the predictions equal
    j, t, _, _, Xte, yte = _carried_lcksvd(rng)
    assert t.cfg == lt.LCKSVDConfig(K=24, T=4, n_iter=3) and t.C_ == 3
    np.testing.assert_allclose(t.transform(Xte).numpy(),
                               np.asarray(j.transform(Xte)), atol=1e-4)
    np.testing.assert_allclose(t.decision_function(Xte).numpy(),
                               np.asarray(j.decision_function(Xte)),
                               atol=1e-4)
    np.testing.assert_array_equal(t.predict(Xte), np.asarray(j.predict(Xte)))
    assert t.score(Xte, yte) == pytest.approx(j.score(Xte, yte))


@pytest.mark.parametrize("n_iter", [2, 3])
def test_lcksvd_fit_matches_jax_from_the_same_init(rng, monkeypatch, n_iter):
    # both fits from the same per-class D0s (init_dictionary replaced on
    # both sides): the per-class init, the ridge A0 and W0 within 1e-4,
    # then the stacked K-SVD, the unstacking and the renormalization: D_,
    # A_ and W_ within 2e-4 (the atom update's tolerance), the stacked
    # objectives within rtol 1e-4
    Xtr, ytr, _ = _digits_like(rng, C=3, per=40)
    D0s = rng.standard_normal((3, 32, 8))
    D0s = (D0s / np.linalg.norm(D0s, axis=1, keepdims=True)).astype(
        np.float32)
    cfg = dict(K=24, T=4, n_iter=n_iter, seed=5)
    ridged = {"jax": [], "torch": []}

    def init_from(to):
        return lambda X, K, method, seed: to(D0s[seed - cfg["seed"]])

    def recording(side, ridge_fn):
        def wrapped(*a, **kw):
            ridged[side].append(np.asarray(ridge_fn(*a, **kw)))
            return ridged[side][-1] if side == "jax" else _t(ridged[side][-1])
        return wrapped

    monkeypatch.setattr(jlc, "init_dictionary", init_from(_j))
    monkeypatch.setattr(tlc, "init_dictionary", init_from(_t))
    monkeypatch.setattr(jlc, "ridge", recording("jax", jlc.ridge))
    monkeypatch.setattr(tlc, "ridge", recording("torch", tlc.ridge))
    j = JLCKSVD(JLCKSVDConfig(**cfg)).fit(Xtr, ytr)
    t = lt.LCKSVD(lt.LCKSVDConfig(**cfg), device="cpu").fit(Xtr, ytr)
    assert len(ridged["torch"]) == len(ridged["jax"]) == 2    # A0, W0
    for got, want in zip(ridged["torch"], ridged["jax"]):
        np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose([h["objective"] for h in t.history_],
                               [h["objective"] for h in j.history_],
                               rtol=1e-4)
    for got, want in ((t.D_, j.D_), (t.A_, j.A_), (t.W_, j.W_)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("K", [24, 25])
def test_lcksvd_fit_on_toy_digits(rng, K):
    # tests/test_classify.py's end-to-end rule (train > 0.9, test > 0.8),
    # shapes, unit atoms and the parts of the fit's time; K=25 is not a
    # multiple of the 3 classes, so the init takes the per-class
    # KSVDLearner branch
    Xtr, ytr, protos = _digits_like(rng, C=3, per=40)
    Xte, yte, _ = _digits_like(rng, C=3, per=15, protos=protos)
    clf = lt.LCKSVD(lt.LCKSVDConfig(K=K, T=4, n_iter=4), device="cpu").fit(
        Xtr, ytr)
    assert clf.D_.shape == (32, K) and clf.A_.shape == (K, K)
    assert clf.W_.shape == (3, K)
    np.testing.assert_allclose(torch.linalg.norm(clf.D_, dim=0).numpy(), 1.0,
                               atol=1e-5)
    assert set(clf.timings_) == {"init_s", "ridge_init_s", "stacked_fit_s"}
    assert len(clf.history_) == 4
    assert clf.score(Xtr, ytr) > 0.9 and clf.score(Xte, yte) > 0.8


# ---- SRC -----------------------------------------------------------------

def test_src_matches_jax_from_a_carried_state(rng):
    Xtr, ytr, protos = _digits_like(rng, per=20)
    Xte, yte, _ = _digits_like(rng, per=10, protos=protos)
    j = JSRC(T=5).fit(Xtr, ytr)
    t = src_from_reference(np.asarray(j.D_), j.y_, 5, device="cpu")
    fitted = lt.SRCClassifier(T=5, device="cpu").fit(Xtr, ytr)
    np.testing.assert_allclose(fitted.D_.numpy(), np.asarray(j.D_),
                               atol=1e-6)
    r = t.residuals(Xte)
    assert r.shape == (4, Xte.shape[1])
    np.testing.assert_allclose(r.numpy(), np.asarray(j.residuals(Xte)),
                               atol=1e-4)
    np.testing.assert_array_equal(t.predict(Xte), j.predict(Xte))
    assert t.score(Xte, yte) > 0.9


def test_src_matches_oracle(rng):
    # the reference's rule: fp32 and fp64 tie-breaks may differ, so > 0.9
    Xtr, ytr, protos = _digits_like(rng, C=3, per=12, p=24)
    Xte, _, _ = _digits_like(rng, C=3, per=4, p=24, protos=protos)
    ref = oracle.src_predict(Xtr.astype(np.float64), ytr,
                             Xte.astype(np.float64), T=5)
    out = lt.SRCClassifier(T=5, normalize=False, device="cpu").fit(
        Xtr, ytr).predict(Xte)
    assert (ref == out).mean() > 0.9


def test_src_takes_another_encoder(rng):
    Xtr, ytr, protos = _digits_like(rng, per=20)
    Xte, yte, _ = _digits_like(rng, per=10, protos=protos)
    enc = lt.SparseEncoder("bomp", {"T": 5}, check_atoms=False,
                           device="cpu")
    got = lt.SRCClassifier(encoder=enc).fit(_t(Xtr), torch.from_numpy(ytr))
    want = JSRC(encoder=JSparseEncoder("bomp", {"T": 5},
                                       check_atoms=False)).fit(Xtr, ytr)
    np.testing.assert_array_equal(got.predict(Xte), want.predict(Xte))


# ---- end to end on the real digits --------------------------------------

def test_digits_end_to_end_matches_jax():
    # config 5 reduced (600 training and 300 test digits, K=100, T=5, 4
    # iterations): each package fits from its own init; LC-KSVD's and SRC's
    # accuracies within 0.03 of the reference's
    datasets = pytest.importorskip("sklearn.datasets")
    d = datasets.load_digits()
    X = d.data.T.astype(np.float32)
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-9)
    perm = np.random.default_rng(0).permutation(X.shape[1])
    tr, te = perm[:600], perm[600:900]
    Xtr, ytr, Xte, yte = X[:, tr], d.target[tr], X[:, te], d.target[te]
    cfg = dict(K=100, T=5, n_iter=4)
    t = lt.LCKSVD(lt.LCKSVDConfig(**cfg), device="cpu").fit(Xtr, ytr)
    j = JLCKSVD(JLCKSVDConfig(**cfg)).fit(Xtr, ytr)
    acc_t, acc_j = t.score(Xte, yte), j.score(Xte, yte)
    assert acc_t > 0.9 and abs(acc_t - acc_j) <= 0.03, (acc_t, acc_j)
    src_t = lt.SRCClassifier(T=10, device="cpu").fit(Xtr, ytr).score(Xte, yte)
    src_j = JSRC(T=10).fit(Xtr, ytr).score(Xte, yte)
    assert src_t > 0.9 and abs(src_t - src_j) <= 0.03, (src_t, src_j)
