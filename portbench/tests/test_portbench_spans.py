"""The span readers (``core/spans.py`` and the metrics built on it) on
hand-built span lists, and a whole traced run of each cell on the CPU at
small sizes, whose line carries the cell's span metrics."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench.core import harness, spans, spec

R = SimpleNamespace


def rec(name, start, end, parent=-1, request=0, **attrs):
    return R(name=name, start_ns=start, end_ns=end, parent=parent,
             request=request, attrs=attrs)


def two_requests():
    """Request 0: a top span (0-100) with two children (10-30, 25-60) and
    a grandchild; request 1: a top span (200-260) with one child."""
    return [
        rec("top", 0, 100, n=4),
        rec("kid", 10, 30, 0),
        rec("leaf", 12, 20, 1),
        rec("kid", 25, 60, 0),
        rec("top", 200, 260, request=1, n=6),
        rec("kid", 210, 250, 4, request=1),
    ]


def test_self_time_leaves_out_what_children_cover():
    win = spans.window(two_requests(), 2)
    # request 0: 100 - (10..60 covered: 50); request 1: 60 - 40
    assert spans.self_ns(win, "top") == 50 + 20
    # a kid's grandchild counts against the kid only
    assert spans.self_ns(win, "kid") == (20 - 8) + 35 + 40
    assert spans.total_ns(win, "kid") == 20 + 35 + 40
    assert spans.total_ns(win, "leaf", "kid") == 8
    assert spans.total_ns(win, "leaf", "top") is None
    assert spans.attr_sum(win, "top", "n") == 10
    assert spans.self_ns(win, "none") is None


def test_window_keeps_the_last_requests():
    recs = two_requests()
    win = spans.window(recs, 1)
    assert sorted(win) == [4, 5]
    assert spans.total_ns(win, "top") == 60
    assert spans.self_ns(win, "top") == 20
    # an open span is left out
    recs.append(rec("top", 300, None, request=2))
    assert sorted(spans.window(recs, 1)) == []
    assert sorted(spans.window(recs, 2)) == [4, 5]


@pytest.mark.parametrize("records,requests", [([], 1), (two_requests(), 3),
                                              (two_requests(), 0)],
                         ids=["empty", "short", "no-requests"])
def test_window_is_none_without_enough_requests(records, requests):
    assert spans.window(records, requests) is None


def ctx(requests):
    return SimpleNamespace(trace=None if requests is None
                           else SimpleNamespace(requests=requests))


def test_per_request_is_none_without_a_trace_or_a_store(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: two_requests())
    assert spans.per_request(ctx(None), lambda w: 1) is None
    assert spans.per_request(ctx(3), lambda w: 1) is None
    got = spans.per_request(ctx(2), lambda w: spans.total_ns(w, "kid"), 1e-6)
    assert got == pytest.approx(95 * 1e-6 / 2)
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert spans.per_request(ctx(2), lambda w: 1) is None
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    assert spans.per_request(ctx(1), lambda w: 1) is None


SPAN_METRICS = {
    "bomp-k1024.bulk": ["frontend_ms.coding", "solver_ms.coding"],
    "denoise-512.dct": ["phase2_ms.denoise", "phase2_lanes.denoise"],
    "denoise-512.adaptive": ["code_s.learning", "sweep_s.learning",
                             "prep_s.learning"],
}

SMALL = {
    "bomp-k1024.bulk": {"patches_per_request": 4096, "block": 2048,
                        "sample_lanes": 512, "trace_requests": 2},
    "denoise-512.dct": {"image": 64, "pool": 4, "warmup_requests": 4,
                        "trace_requests": 2},
    "denoise-512.adaptive": {"image": 64, "n_train": 2000, "n_iter": 2,
                             "K": 64, "pool": 2},
}


def test_span_metrics_are_listed_for_their_cells():
    listed = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for cell, names in SPAN_METRICS.items():
        for n in names:
            assert listed[n]["source"] == "program_span"
            assert listed[n]["workloads"] == [cell]


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_run_carries_the_span_metrics(cell):
    res = harness.run(cell, 2**31 + 11, 0.2, True,
                      devices=[torch.device("cpu")],
                      t_start=time.perf_counter(), overrides=SMALL[cell])
    assert res["correct"], res["checks"]
    for n in SPAN_METRICS[cell]:
        assert n in res["metrics"], (n, sorted(res["metrics"]))
        assert res["metrics"][n]["value"] >= 0
