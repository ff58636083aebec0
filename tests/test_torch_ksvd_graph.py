"""The dense K-SVD sweep replayed from its CUDA graph, on the card: at the
adaptive denoiser's training shape (p=64, K=256, N=30,000, B=1), with the
sweep kernel's envelope (``ops.cuda_ksvd_sweep.takes``) refusing every key
as it refuses those past its limits, the first
sweep of a shape runs eager, the second captures (on a cold stream after a
warm-up sweep that is its result), and every replay equals
the eager sweep bit for bit, leaves its inputs alone and hands out
tensors of its own; a capture that runs out of device memory leaves its
key eager.  Skipped without a CUDA GPU.  Imports no JAX, so that the card
can run it without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ksvd_graph.py
"""

import importlib
from collections import OrderedDict

import pytest
import torch

from lyssandra_tpu_torch.utils import clear_spans, spans

tksvd = importlib.import_module("lyssandra_tpu_torch.dict_learning.ksvd")
cuda_ksvd_sweep = importlib.import_module(
    "lyssandra_tpu_torch.ops.cuda_ksvd_sweep")

P, K, N, T = 64, 256, 30_000, 6


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card)")
    # the graph path: the key that the kernel would take goes to it
    monkeypatch.setattr(cuda_ksvd_sweep, "takes", lambda *a: False)
    # a cache of this test's own
    monkeypatch.setattr(tksvd, "_graphs", OrderedDict())
    monkeypatch.setattr(tksvd, "_no_graph", set())
    monkeypatch.setattr(tksvd, "_side", tksvd._SideStreams())
    return torch.device("cuda", 0)


def problem(seed, dev, p=P, k=K, n=N, t=T):
    """Unit atoms D (p, k), codes Gamma (k, n) with t nonzeros a column,
    and X = D Gamma plus noise, drawn on the card from ``seed``."""
    g = torch.Generator(dev).manual_seed(seed)
    D = torch.randn(p, k, generator=g, device=dev)
    D /= torch.linalg.vector_norm(D, dim=0, keepdim=True)
    idx = torch.rand(k, n, generator=g, device=dev).topk(t, dim=0).indices
    Gamma = torch.zeros(k, n, device=dev).scatter_(
        0, idx, torch.randn(t, n, generator=g, device=dev))
    X = D @ Gamma + 0.05 * torch.randn(p, n, generator=g, device=dev)
    return X, D, Gamma


def key_of(dev, n=N, n_power=1):
    return (dev, torch.float32, P, n, K, 1, n_power)


def traced(x, **kw):
    """``ksvd_atom_update(*x, **kw)`` and its sweep span's ``replayed``."""
    clear_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = tksvd.ksvd_atom_update(*x, **kw)
        recs = [r for r in spans() if r.name == "lyssa.ksvd.sweep"]
    finally:
        clear_spans()
    torch.cuda.synchronize()
    assert len(recs) == 1
    return out, recs[0].attrs["replayed"]


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.card
@pytest.mark.parametrize("kw", [{}, {"exact": True, "svd_iters": 3}],
                         ids=["power1", "exact3"])
def test_replay_equals_the_eager_sweep_bit_for_bit(card, kw):
    n_power = kw.get("svd_iters", 1)
    key = key_of(card, n_power=n_power)
    one, two = problem(1, card), problem(2, card)
    copies = [[a.clone() for a in x] for x in (one, two)]
    eager = [tksvd._sweep(*x, 1, n_power) for x in (one, two)]

    first, replayed = traced(one, **kw)
    assert replayed == 0 and tksvd._graphs[key] is None
    second, replayed = traced(two, **kw)
    assert replayed == 0
    assert isinstance(tksvd._graphs[key], tksvd._SweepGraph)
    assert same(first, eager[0]) and same(second, eager[1])

    # two inputs in turn: the statics hold each call's own
    for x, want in ((one, eager[0]), (two, eager[1]), (one, eager[0])):
        got, replayed = traced(x, **kw)
        assert replayed == 1
        assert same(got, want)
    for x, kept in zip((one, two), copies):
        assert same(x, kept)

    # what a replay hands out is the caller's: writing into it changes
    # neither the graph nor the next replay
    got[0].fill_(7.0)
    got[1].fill_(7.0)
    again = tksvd.ksvd_atom_update(*one, **kw)
    assert same(again, eager[0])
    graph = tksvd._graphs[key]
    ptrs = {t.data_ptr() for t in graph.inputs + graph.outputs}
    assert not ptrs & {t.data_ptr() for t in got + again + second}


@pytest.mark.card
def test_capture_on_a_cold_stream_returns_its_warm_up(card):
    # the first sweep warms this thread's side stream; another thread's
    # capture warms its own first, and that sweep is the call's result
    import threading

    x = problem(3, card)
    key = key_of(card)
    want = tksvd._sweep(*x, 1, 1)
    assert same(tksvd.ksvd_atom_update(*x), want)
    got = []
    worker = threading.Thread(
        target=lambda: got.append(tksvd.ksvd_atom_update(*x)))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert len(got) == 1 and same(got[0], want)
    graph = tksvd._graphs[key]
    assert isinstance(graph, tksvd._SweepGraph)
    again, replayed = traced(x)
    assert replayed == 1 and same(again, want)
    ptrs = {t.data_ptr() for t in graph.inputs + graph.outputs}
    assert not ptrs & {t.data_ptr() for t in got[0]}


@pytest.mark.card
def test_sweep_inside_a_callers_capture_runs_eager(card):
    x = problem(4, card, n=4096)
    want = tksvd._sweep(*x, 1, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tksvd._sweep(*x, 1, 1)
    torch.cuda.current_stream().wait_stream(side)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        out = tksvd.ksvd_atom_update(*x)
    assert not tksvd._graphs and not tksvd._no_graph
    outer.replay()
    torch.cuda.synchronize()
    assert same(out, want)


def reserved_by(fn):
    """The device memory the allocator reserves anew to run fn()."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_reserved() - r0


@pytest.mark.card
def test_capture_out_of_memory_runs_eager_and_is_not_retried(card,
                                                             monkeypatch):
    x = problem(5, card)
    key = key_of(card)
    want, sweep_bytes = reserved_by(lambda: tksvd._sweep(*x, 1, 1))
    statics = sum(a.numel() * a.element_size() for a in x) + (8 << 20)
    assert same(tksvd.ksvd_atom_update(*x), want)       # eager: seen once

    # the capturing call copies the inputs and captures a sweep in the
    # graph's pool (its stream is warm from the first): room for the copies
    # and half the sweep, so that memory runs out inside the capture
    began = []
    capture_begin = torch.cuda.CUDAGraph.capture_begin

    def counted_begin(self, *a, **k):
        began.append(k)
        return capture_begin(self, *a, **k)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", counted_begin)
    reserved_by(lambda: None)                    # an empty cache
    allowed = torch.cuda.memory_reserved() + statics + 0.5 * sweep_bytes
    total = torch.cuda.get_device_properties(card).total_memory
    torch.cuda.set_per_process_memory_fraction(allowed / total, card)
    try:
        got = tksvd.ksvd_atom_update(*x)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, card)
    assert began == [{"capture_error_mode": "thread_local"}]
    assert key in tksvd._no_graph and key not in tksvd._graphs
    assert same(got, want)
    for _ in range(2):
        got, replayed = traced(x)
        assert replayed == 0 and same(got, want)
    assert len(began) == 1 and key not in tksvd._graphs
