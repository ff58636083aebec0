"""The port's experiment Workspace: arrays, metrics and JSON results laid
out as the reference's (its .npz files load in either package), and
torch.save checkpoints that keep the 3 newest."""

import os

import numpy as np
import pytest
import torch

from lyssandra_tpu.utils import Workspace as JWorkspace
from lyssandra_tpu_torch import Workspace


def test_arrays_round_trip(tmp_path):
    ws = Workspace(str(tmp_path / "w"))
    D = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    path = ws.save_array("D", D)
    assert path == os.path.join(ws.root, "D.npz")
    np.testing.assert_array_equal(ws.load_array("D"), D.numpy())
    ws.save_array("pair", a=np.ones(3), b=torch.zeros(2, dtype=torch.int32))
    got = ws.load_array("pair")
    assert sorted(got) == ["a", "b"] and got["b"].dtype == np.int32
    ws.save_array("two", np.ones(2), np.zeros(3))
    assert sorted(ws.load_array("two")) == ["arr_0", "arr_1"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_arrays_shared_with_the_reference(tmp_path, writer):
    root = str(tmp_path / "w")
    ours, theirs = Workspace(root), JWorkspace(root)
    src, dst = (ours, theirs) if writer == "port" else (theirs, ours)
    D = np.random.default_rng(0).standard_normal((8, 5)).astype(np.float32)
    src.save_array("D", D)
    src.save_array("codes", idx=np.arange(6), gamma=D[0])
    np.testing.assert_array_equal(dst.load_array("D"), D)
    got = dst.load_array("codes")
    np.testing.assert_array_equal(got["idx"], np.arange(6))
    np.testing.assert_array_equal(got["gamma"], D[0])


def test_metrics_and_json(tmp_path):
    ws = Workspace(str(tmp_path / "w"))
    assert ws.read_metrics() == []
    ws.log_metrics({"iter": 0, "objective": 2.5})
    ws.log_metrics({"iter": 1, "objective": 2.0})
    assert ws.read_metrics() == [{"iter": 0, "objective": 2.5},
                                 {"iter": 1, "objective": 2.0}]
    assert JWorkspace(ws.root).read_metrics() == ws.read_metrics()
    ws.save_json("result", {"psnr": 30.5, "shape": (2, 3)})
    assert ws.load_json("result") == {"psnr": 30.5, "shape": [2, 3]}
    assert JWorkspace(ws.root).load_json("result") == ws.load_json("result")


def test_checkpoints_keep_the_newest_three(tmp_path):
    ws = Workspace(str(tmp_path / "w"))
    assert ws.load_latest_state() == (None, None)
    for step in (1, 4, 9, 12):
        ws.save_state(step, {"D": torch.full((2, 2), float(step)),
                             "iter": torch.tensor(step, dtype=torch.int32),
                             "meta": {"lr": 0.5, "hist": [step, step + 1]}})
    names = sorted(os.listdir(os.path.join(ws.root, "checkpoints")))
    assert names == ["step_00000004.pt", "step_00000009.pt",
                     "step_00000012.pt"]
    step, state = ws.load_latest_state()
    assert step == 12 and int(state["iter"]) == 12
    assert torch.equal(state["D"], torch.full((2, 2), 12.0))
    assert state["meta"] == {"lr": 0.5, "hist": [12, 13]}


def test_checkpoint_template_sets_dtype_and_device(tmp_path):
    ws = Workspace(str(tmp_path / "w"))
    ws.save_state(0, {"D": torch.ones(3, dtype=torch.float64),
                      "iter": torch.tensor(0)})
    template = {"D": torch.zeros(3, dtype=torch.float32),
                "iter": torch.zeros((), dtype=torch.int32)}
    step, state = ws.load_latest_state(template)
    assert step == 0
    assert state["D"].dtype == torch.float32
    assert state["iter"].dtype == torch.int32
    assert state["D"].device == template["D"].device


def test_a_later_run_resumes_the_newest_step(tmp_path):
    root = str(tmp_path / "w")
    Workspace(root).save_state(5, {"D": torch.ones(2)})
    Workspace(root).save_state(7, {"D": torch.zeros(2)})
    step, state = Workspace(root).load_latest_state()
    assert step == 7 and not state["D"].any()
