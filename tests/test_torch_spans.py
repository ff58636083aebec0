"""The port's program spans (``lyssandra_tpu_torch.utils.profiling``): off
they cost a flag read and record nothing; under ``torch.profiler`` each is
a ``record_function`` range and a record of (name, start_ns, end_ns,
parent, request, attrs) in a bounded store.  Then the spans of the encoder,
the denoiser's second phase and K-SVD's fit.  CPU only; no JAX."""

import importlib
import json
import math
import threading
import time

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.parallel import make_mesh
from lyssandra_tpu_torch.solvers.greedy import GreedyResult, _omp_impl
from lyssandra_tpu_torch.utils import (
    clear_spans,
    dropped_spans,
    profile_trace,
    span,
    spanned,
    spans,
)

profiling = importlib.import_module("lyssandra_tpu_torch.utils.profiling")
tdenoise = importlib.import_module("lyssandra_tpu_torch.apps.denoise")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_store():
    clear_spans()
    yield
    clear_spans()


def traced(fn):
    """fn() under the profiler (CPU activity); (its result, the span
    records it left, the profiler)."""
    clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans(), prof


def named(records, name):
    return [(i, r) for i, r in enumerate(records) if r.name == name]


class CountOps(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        return func(*args, **(kwargs or {}))


@spanned("lyssa.test")
def _nothing():
    """Does nothing."""


def _with_span():
    with span("lyssa.test", n=1):
        pass


@pytest.mark.parametrize("mark", [_with_span, _nothing],
                         ids=["span", "spanned"])
def test_disabled_span_records_nothing_and_costs_under_a_microsecond(mark):
    with CountOps() as ops:
        mark()
    assert ops.calls == 0 and spans() == [] and dropped_spans() == 0
    n, best = 100_000, math.inf
    for _ in range(5):               # the best of five batches of 100,000
        t0 = time.perf_counter()
        for _ in range(n):
            mark()
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, f"{best * 1e9:.0f} ns a disabled span"
    assert spans() == []


def test_nested_spans_get_parent_request_and_attrs():
    def work():
        with span("a", n=3):
            with span("b"):
                with span("c", k=1):
                    pass
            with span("d"):
                pass
        with span("e"):
            pass

    _, recs, _ = traced(work)
    assert [r.name for r in recs] == ["a", "b", "c", "d", "e"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0, -1]
    assert recs[0].request == recs[1].request == recs[2].request \
        == recs[3].request != recs[4].request
    assert recs[0].attrs == {"n": 3}
    assert recs[2].attrs == {"k": 1} and recs[1].attrs == {}
    for r in recs:
        assert r.start_ns <= r.end_ns
    assert recs[0].start_ns <= recs[1].start_ns <= recs[2].end_ns \
        <= recs[1].end_ns <= recs[3].start_ns <= recs[0].end_ns


def test_spanned_function_is_one_span_and_keeps_its_name():
    @spanned("lyssa.outer")
    def outer(x, *, fail=False):
        """Adds one."""
        with span("lyssa.inner"):
            if fail:
                raise ValueError("planted")
            return x + 1

    assert outer.__name__ == "outer" and outer.__doc__ == "Adds one."
    assert outer(1) == 2 and spans() == []          # no profiler: no span
    got, recs, _ = traced(lambda: outer(torch.ones(2)))
    assert torch.equal(got, torch.full((2,), 2.0))
    assert [(r.name, r.parent, r.attrs) for r in recs] == [
        ("lyssa.outer", -1, {}), ("lyssa.inner", 0, {})]

    def fails():
        with pytest.raises(ValueError, match="planted"):
            outer(1, fail=True)
        with span("lyssa.after"):
            pass

    _, recs, _ = traced(fails)
    # a raising call closes its spans: the next span starts a new request
    assert [r.name for r in recs] == ["lyssa.outer", "lyssa.inner",
                                      "lyssa.after"]
    assert all(r.end_ns is not None for r in recs)
    assert recs[2].parent == -1 and recs[2].request != recs[0].request


def test_spans_of_another_thread_start_their_own_request():
    def other():
        with span("other"):
            pass

    def work():
        with span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()

    _, recs, _ = traced(work)
    by = {r.name: r for r in recs}
    assert by["other"].parent == -1
    assert by["other"].request != by["main"].request


def test_each_span_lies_inside_its_profiler_event():
    def work():
        x = torch.ones(8)
        for i in range(200):
            with span(f"lyssa.inside.{i}"):
                x = x + 1
        return x

    _, recs, prof = traced(work)
    assert len(recs) == 200
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("lyssa.inside."):
            events[e.name()] = (e.start_ns(), e.start_ns() + e.duration_ns())
    assert len(events) == 200
    for r in recs:
        s, e = events[r.name]
        assert s <= r.start_ns <= r.end_ns <= e, r.name


@pytest.mark.parametrize("N,block", [(1000, 256), (200, 256)],
                         ids=["blocks", "one-call"])
def test_encode_has_one_block_span_per_block(N, block):
    g = torch.Generator().manual_seed(1)
    D = torch.nn.functional.normalize(torch.randn(16, 64, generator=g), dim=0)
    X = torch.randn(16, N, generator=g)
    enc = lt.SparseEncoder("bomp", {"T": 4}, block=block, device="cpu")
    want = enc.encode(X, D)
    got, recs, _ = traced(lambda: enc.encode(X, D))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    top = named(recs, "lyssa.encode")
    assert len(top) == 1
    i, r = top[0]
    blocks = math.ceil(N / block)
    assert r.attrs == {} and r.parent == -1
    kids = named(recs, "lyssa.encode.block")
    assert len(kids) == blocks and all(k.parent == i for _, k in kids)


def _straggler_problem(rng, N=96, p=16, K=64):
    """Signals of 4-6 atoms: a T1=2 first pass leaves many lanes
    unconverged (the setting of the denoiser's straggler test)."""
    D = rng.standard_normal((p, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    G0 = np.zeros((K, N), np.float32)
    for i in range(N):
        sup = rng.choice(K, size=4 + (i % 3), replace=False)
        G0[sup, i] = rng.standard_normal(len(sup))
    return D, (D @ G0).astype(np.float32)


def _two_phase_any(D, Xc, *, eps, T1, T_max, cap=4096):
    """The two-phase coder with its loop asking ``bool(bad.any())`` a
    round: the codes that counting the lanes left must not change."""
    K, N = D.shape[1], Xc.shape[1]
    res = tdenoise._omp_fused_call(D, Xc, T=T1, eps=eps, eps_mode=True,
                                   dense=False)
    bad = (res.nsel == T1) & (res.err > eps * eps)
    Gamma = GreedyResult(*(torch.cat([f, f.new_zeros((1,) + f.shape[1:])])
                           for f in res)).dense(K)
    slots, lanes = torch.arange(cap), torch.arange(N)
    while bool(bad.any()):
        pos = torch.cumsum(bad, dim=0) - 1
        sel = bad & (pos < cap)
        cols = torch.zeros((cap + 1,), dtype=torch.long)
        cols.scatter_(0, torch.where(sel, pos, cap), lanes)
        cols = cols[:cap]
        rs = _omp_impl(D, Xc[:, cols], eps, T=T_max, eps_mode=True)
        Gamma[:, torch.where(slots < sel.sum(), cols, N)] = rs.dense(K)
        bad = bad & ~sel
    return Gamma[:, :N]


def _stragglers(D, Xc, eps, T1):
    """The lanes the first phase leaves: all T1 atoms used and the error
    still above eps, from a plain OMP pass of its own."""
    res = _omp_impl(D, Xc, eps, T=T1, eps_mode=True)
    return int(((res.nsel == T1) & (res.err > eps * eps)).sum())


def test_phase2_span_counts_the_stragglers_over_several_rounds(monkeypatch):
    # the straggler test's setting: cap=16 below the straggler count
    D, X = _straggler_problem(np.random.default_rng(0))
    D, X = torch.from_numpy(D), torch.from_numpy(X)
    kw = dict(eps=1e-3, T1=2, T_max=6, cap=16)
    rounds = []           # per re-solve, the innermost open span

    def resolve(*a, **k):
        stack = profiling._STORE._stack()
        rounds.append(stack[-1].name if stack else None)
        return _omp_impl(*a, **k)

    monkeypatch.setattr(tdenoise, "_omp_impl", resolve)
    got, recs, _ = traced(lambda: tdenoise._eps_two_phase(D, X, **kw))
    lanes = _stragglers(D, X, kw["eps"], kw["T1"])
    assert lanes > 16
    (_, r), = named(recs, "lyssa.denoise.phase2")
    assert r.attrs == {"lanes": lanes}
    assert rounds == ["lyssa.denoise.phase2"] * math.ceil(lanes / 16)
    assert torch.equal(got, _two_phase_any(D, X, **kw))
    assert torch.equal(got, tdenoise._eps_two_phase(D, X, **kw))


@pytest.mark.parametrize("sigma", [16.0, 22.0], ids=["phase2", "none"])
def test_denoiser_image_phase2_lanes_and_bit_identical_output(sigma,
                                                              monkeypatch):
    # noise of 25 against a sigma of 16: the lanes that 10 atoms do not
    # bring within eps (174 of 625) take the second phase; at 22 none do,
    # and the span is opened all the same
    rng = np.random.default_rng(3)
    x = np.linspace(0, 2 * np.pi, 32)
    img = 100 + 60 * np.outer(np.sin(x), np.cos(x))
    noisy = (img + 25 * rng.standard_normal(img.shape)).astype(np.float32)
    cfg = lt.DenoiseConfig(patch=8, sigma=sigma, T_max=32)
    den = lt.Denoiser(lt.dct_dictionary(8, 64, device="cpu"), cfg,
                      device="cpu")
    assert den._fast_path()
    got, recs, _ = traced(lambda: den(noisy))
    Xc, _, _ = lt.ops.fused_patch_pipeline(torch.from_numpy(noisy), 8,
                                           do_dc=True)
    eps = cfg.gain * 8 * cfg.sigma
    lanes = _stragglers(den.D, Xc, eps, 10)
    assert (0 < lanes < Xc.shape[1]) == (sigma == 16.0)
    (i, top), = named(recs, "lyssa.denoise")
    (_, ph2), = named(recs, "lyssa.denoise.phase2")
    assert ph2.parent == i and ph2.request == top.request
    assert ph2.attrs == {"lanes": lanes}
    monkeypatch.setattr(tdenoise, "_eps_two_phase",
                        lambda D, Xc, order="raster", **kw:
                        _two_phase_any(D, Xc, **kw))
    assert torch.equal(got, den(noisy))


@pytest.mark.parametrize("codes", ["dense", "compact"])
def test_ksvd_fit_spans_each_iteration(codes):
    g = torch.Generator().manual_seed(2)
    X = torch.randn(16, 600, generator=g)
    n = 3
    learner = lt.KSVDLearner(lt.KSVDConfig(K=32, T=3, n_iter=n, codes=codes),
                             device="cpu")
    _, recs, _ = traced(lambda: learner.fit(X))
    (f, fit), = named(recs, "lyssa.ksvd.fit")
    assert fit.attrs == {} and fit.parent == -1
    its = named(recs, "lyssa.ksvd.iteration")
    assert len(its) == n and all(r.parent == f for _, r in its)
    for i, _ in its:
        kids = sorted(r.name for r in recs if r.parent == i)
        assert kids == ["lyssa.encode", "lyssa.ksvd.post",
                        "lyssa.ksvd.sweep"]
    assert len({r.request for r in recs}) == 1


def test_encode_on_a_mesh_has_one_block_span_per_block():
    # the mesh route's blocks: each one's per-slot calls inside its span
    g = torch.Generator().manual_seed(5)
    D = torch.nn.functional.normalize(torch.randn(16, 64, generator=g), dim=0)
    X = torch.randn(16, 1000, generator=g)
    enc = lt.SparseEncoder("bomp", {"T": 4}, block=256,
                           mesh=make_mesh(devices=["cpu"] * 4))
    want = enc.encode(X, D)
    got, recs, _ = traced(lambda: enc.encode(X, D))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (i, _), = named(recs, "lyssa.encode")
    kids = named(recs, "lyssa.encode.block")
    assert len(kids) == 4 and all(k.parent == i for _, k in kids)


def test_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling._STORE, "capacity", 3)

    def work():
        for _ in range(5):
            with span("outer"):
                with span("inner"):
                    pass

    _, recs, _ = traced(work)
    assert [r.name for r in recs] == ["outer", "inner", "outer"]
    assert dropped_spans() == 7
    clear_spans()
    assert spans() == [] and dropped_spans() == 0


def test_profile_trace_carries_the_program_spans(tmp_path):
    g = torch.Generator().manual_seed(4)
    D = torch.nn.functional.normalize(torch.randn(8, 16, generator=g), dim=0)
    X = torch.randn(8, 50, generator=g)
    with profile_trace(str(tmp_path)):
        lt.SparseEncoder("bomp", {"T": 2}, block=32,
                         device="cpu").encode(X, D)
    with open(tmp_path / "trace.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("lyssa.encode") == 1
    assert names.count("lyssa.encode.block") == 2
    assert [r.name for r in spans()].count("lyssa.encode.block") == 2
