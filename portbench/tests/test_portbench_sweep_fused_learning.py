"""``sweep_fused.learning``: the ``fused`` attribute of the program's
``lyssa.ksvd.sweep`` spans, summed a task, on hand-built span lists; None
where no sweep span carries it (a program that predates the sweep's
kernel); and traced runs of both K-SVD cells on the CPU at small sizes,
where every sweep runs the dense loop, so the line reads 0."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench.core import harness, spans, spec

NAME = "sweep_fused.learning"
CELLS = ["denoise-512.adaptive", "ksvd-c2.fit"]
SMALL = {
    "denoise-512.adaptive": {"image": 64, "n_train": 2000, "n_iter": 2,
                             "K": 64, "pool": 2},
    "ksvd-c2.fit": {"image": 64, "n_train": 1500, "K": 128, "n_iter": 3,
                    "pool": 2},
}


def reader():
    return spec.load_module(spec.BENCH / "metrics" / f"{NAME}.py",
                            "portbench_metric_" + NAME)


def rec(name, start, end, parent=-1, request=0, **attrs):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end,
                           parent=parent, request=request, attrs=attrs)


def ctx(requests):
    return SimpleNamespace(trace=SimpleNamespace(requests=requests))


def tasks(fused):
    """One task a list of sweep ``fused`` values (None: the attribute left
    out), each sweep under an iteration span under a fit span."""
    out = []
    for t, values in enumerate(fused):
        top = len(out)
        out.append(rec("lyssa.ksvd.fit", 100 * t, 100 * t + 90, request=t))
        for i, v in enumerate(values):
            it = len(out)
            out.append(rec("lyssa.ksvd.iteration", 100 * t + 2 * i,
                           100 * t + 2 * i + 2, top, t))
            attrs = {"replayed": 0}
            if v is not None:
                attrs["fused"] = v
            out.append(rec("lyssa.ksvd.sweep", 100 * t + 2 * i + 1,
                           100 * t + 2 * i + 2, it, t, **attrs))
    return out


@pytest.mark.parametrize("fused,requests,want", [
    ([[1] * 20], 1, 20.0),
    ([[1] * 12], 1, 12.0),
    ([[0, 0], [1, 1, 1]], 2, 1.5),
    ([[0, 0], [1, 1, 1]], 1, 3.0),
    ([[0, 0, 0]], 1, 0.0),
    ([[None, None]], 1, None),
    ([[]], 1, None),
], ids=["ksvd-c2", "adaptive", "two-tasks", "last-task", "dense",
        "no-attribute", "no-sweep"])
def test_reader_sums_fused_a_task(monkeypatch, fused, requests, want):
    monkeypatch.setattr(spans, "program_spans", lambda: tasks(fused))
    assert reader().read(ctx(requests)) == want


def test_no_trace_reads_nothing():
    assert reader().read(SimpleNamespace(trace=None)) is None


def test_listed_for_the_ksvd_cells():
    listed = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    m = listed[NAME]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_span", "learning", "task_s", CELLS)
    assert m["unit"] == "sweeps" and m["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_ksvd_run_reads_no_fused_sweep_on_the_cpu(cell):
    res = harness.run(cell, 2**31 + 23, 0.2, True,
                      devices=[torch.device("cpu")],
                      t_start=time.perf_counter(), overrides=SMALL[cell])
    assert res["correct"], res["checks"]
    assert res["metrics"][NAME]["value"] == 0
