"""``scan_fused.lasso``: the ``fused`` attribute of the program's
``lyssa.fs.loop`` spans, summed a task, on hand-built span lists; None
where no loop span carries it (a program whose loop after the cold start
has no kernel); and a traced run of ``lasso-c4.encode`` on the CPU at a
small size, where every loop is the plain one, so the line reads 0."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench.core import harness, spans, spec

NAME = "scan_fused.lasso"
CELL = "lasso-c4.encode"
SMALL = {"image": 32, "patch": 2, "p": 12, "n_train": 1600, "K": 24,
         "batch_size": 256, "n_encode": 600, "block": 128, "sample_span": 2}


def reader():
    return spec.load_module(spec.BENCH / "metrics" / f"{NAME}.py",
                            "portbench_metric_" + NAME)


def rec(name, start, end, parent=-1, request=0, **attrs):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end,
                           parent=parent, request=request, attrs=attrs)


def ctx(requests):
    return SimpleNamespace(trace=SimpleNamespace(requests=requests))


def tasks(fused):
    """One encode a list of loop ``fused`` values (None: the attribute left
    out), each loop under a block span under the encode's span."""
    out = []
    for t, values in enumerate(fused):
        top = len(out)
        out.append(rec("lyssa.encode", 100 * t, 100 * t + 90, request=t))
        for i, v in enumerate(values):
            block = len(out)
            out.append(rec("lyssa.encode.block", 100 * t + 2 * i,
                           100 * t + 2 * i + 2, top, t))
            attrs = {} if v is None else {"fused": v, "syncs": 0,
                                          "segments": 1}
            out.append(rec("lyssa.fs.loop", 100 * t + 2 * i + 1,
                           100 * t + 2 * i + 2, block, t, **attrs))
    return out


@pytest.mark.parametrize("fused,requests,want", [
    ([[1] * 49], 1, 49.0),
    ([[0] * 49, [1] * 49], 2, 24.5),
    ([[0] * 49, [1] * 49], 1, 49.0),
    ([[0] * 49], 1, 0.0),
    ([[None] * 49], 1, None),
    ([[]], 1, None),
], ids=["kernel", "two-tasks", "last-task", "plain", "no-attribute",
        "no-loop"])
def test_reader_sums_fused_a_task(monkeypatch, fused, requests, want):
    monkeypatch.setattr(spans, "program_spans", lambda: tasks(fused))
    assert reader().read(ctx(requests)) == want


def test_no_trace_reads_nothing():
    assert reader().read(SimpleNamespace(trace=None)) is None


def test_listed_for_the_lasso_cell():
    listed = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    m = listed[NAME]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_span", "solvers", "task_s", [CELL])
    assert m["unit"] == "calls" and m["better"] == "higher"


def test_traced_lasso_run_reads_no_fused_loop_on_the_cpu():
    res = harness.run(CELL, 2**31 + 23, 0.2, True,
                      devices=[torch.device("cpu")],
                      t_start=time.perf_counter(), overrides=SMALL)
    assert res["correct"], res["checks"]
    assert res["metrics"][NAME]["value"] == 0
