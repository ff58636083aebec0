"""The online learner's program spans (``lyssa.online.*``) and feature-sign's
cold start (``lyssa.fs.cold``): under ``torch.profiler`` they nest as the
benchmark's readers expect, ``syncs`` is the solvers' host reads over the
coding; off they record nothing and read no counter; on or off, the codes
are the same.  CPU only; no JAX."""

import functools
import importlib

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.solvers.lasso import host_syncs
from lyssandra_tpu_torch.utils import clear_spans, spans

tonline = importlib.import_module("lyssandra_tpu_torch.dict_learning.online")
tlasso = importlib.import_module("lyssandra_tpu_torch.solvers.lasso")

torch.set_num_threads(1)

P, K, BS, LAM = 12, 24, 64, 0.15
CFG = lt.OnlineDLConfig(K=K, lam=LAM, batch_size=BS, chunk_batches=2,
                        code_blocks=2, seed=0)


@pytest.fixture(autouse=True)
def empty_store():
    clear_spans()
    yield
    clear_spans()


def _signals(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(P, n, generator=g)
    return X / torch.linalg.vector_norm(X, dim=0, keepdim=True)


def traced(fn):
    clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, spans()


def named(records, name):
    return [(i, r) for i, r in enumerate(records) if r.name == name]


def _fitted(X, seed=3):
    return lt.OnlineDictionaryLearner(CFG, device="cpu").fit(X, seed=seed)


def test_fit_spans_each_minibatch_with_its_syncs():
    X = _signals(4 * BS)
    s0 = host_syncs()
    learner, recs = traced(lambda: _fitted(X))
    syncs = host_syncs() - s0
    (f, fit), = named(recs, "lyssa.online.fit")
    assert fit.parent == -1 and fit.attrs == {}
    steps = named(recs, "lyssa.online.step")
    assert len(steps) == 4 and all(r.parent == f for _, r in steps)
    for i, _ in steps:
        kids = [r for r in recs if r.parent == i]
        assert [r.name for r in kids] == ["lyssa.online.code",
                                          "lyssa.online.sweep"]
        assert kids[0].attrs["syncs"] > 0
        assert kids[1].attrs == {"fused": 0}    # the plain loop on the CPU
    codes = named(recs, "lyssa.online.code")
    # fit's coder is the only host reader: the spans' counts are all of it
    assert sum(r.attrs["syncs"] for _, r in codes) == syncs
    assert len({r.request for r in recs}) == 1
    assert not named(recs, "lyssa.fs.cold")      # feature_sign_scan's loop


def test_partial_fit_spans_the_cold_start(monkeypatch):
    # partial_fit codes through feature_sign; with its cold start on (the
    # GPU's default; the CPU runs the plain version), the start is a span
    # inside the coding
    monkeypatch.setattr(tonline, "feature_sign",
                        functools.partial(tlasso.feature_sign, cold_unroll=5))
    learner = lt.OnlineDictionaryLearner(CFG, device="cpu")
    learner.partial_fit(_signals(BS, 1))            # the state's init
    s0 = host_syncs()
    _, recs = traced(lambda: learner.partial_fit(_signals(BS, 2)))
    syncs = host_syncs() - s0
    (s, step), = named(recs, "lyssa.online.step")
    assert step.parent == -1
    (c, code), = named(recs, "lyssa.online.code")
    (_, cold), = named(recs, "lyssa.fs.cold")
    (_, sweep), = named(recs, "lyssa.online.sweep")
    assert code.parent == s and sweep.parent == s and cold.parent == c
    assert code.attrs == {"syncs": syncs} and cold.attrs == {}
    assert code.end_ns <= sweep.start_ns


def test_spans_off_record_nothing_and_read_no_counter(monkeypatch):
    # with no profiler the coding span hands out no attribute dict, so the
    # step never reads the solvers' counter
    reads = []
    monkeypatch.setattr(tonline, "host_syncs",
                        lambda: reads.append(1) or host_syncs())
    X = _signals(2 * BS)
    _fitted(X)
    learner = lt.OnlineDictionaryLearner(CFG, device="cpu")
    learner.partial_fit(X[:, :BS])
    assert spans() == [] and reads == []
    _, recs = traced(lambda: _fitted(X))
    assert len(reads) == 4 and len(named(recs, "lyssa.online.code")) == 2


@pytest.mark.parametrize("route", ["fit", "partial_fit"])
def test_codes_and_dictionary_equal_with_spans_on_and_off(route):
    X = _signals(2 * BS, 5)

    def run():
        if route == "fit":
            learner = _fitted(X)
        else:
            learner = lt.OnlineDictionaryLearner(CFG, device="cpu")
            for s in range(0, 2 * BS, BS):
                learner.partial_fit(X[:, s:s + BS])
        return learner

    off = run()
    on, recs = traced(run)
    assert recs
    assert all(torch.equal(a, b) for a, b in zip(off.state[:3],
                                                  on.state[:3]))
    assert [h["batch_objective"] for h in off.history_] == \
        [h["batch_objective"] for h in on.history_]
    np.testing.assert_array_equal(
        tonline.feature_sign_scan(off.D_, X, LAM).numpy(),
        traced(lambda: tonline.feature_sign_scan(on.D_, X, LAM))[0].numpy())
