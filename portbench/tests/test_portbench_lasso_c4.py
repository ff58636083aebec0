"""Config 4's lasso coding cell, ``lasso-c4.encode``, on the CPU at a small
size (p = 12: 2x2x3 patches of the colour stand-ins, K = 24 learned by the
reference from 1,600 training patches in minibatches of 256, 600 patches a
set in blocks of 128, so the last block is padded): its files are found by
name, a sound whole run is correct and reads its span metrics, a run with
the coding broken is not, once for each fault, the control fails the
check, and the counted work against hand-worked cases."""

import importlib
import time

import pytest
import torch

from portbench.core import control, harness, spec
from portbench.yardstick import lasso_encode_work, lasso_work

CELL = "lasso-c4.encode"
SMALL = {"image": 32, "patch": 2, "p": 12, "n_train": 1600, "K": 24,
         "batch_size": 256, "n_encode": 600, "block": 128, "sample_span": 2}
# 54 of the 4 sets' 2,400 lanes are not done after 6 outer iterations, so
# the polish runs and matters
FEW_ITERATIONS = {"max_iter": 6}
SPAN_METRICS = ("loop_s.lasso", "polish_s.lasso")
ENCODER = "lyssandra_tpu_torch.solvers.encoder"
LASSO = "lyssandra_tpu_torch.solvers.lasso"


def run(trace=False, seed=2**31 + 11, **extra):
    return harness.run(CELL, seed, 0.2, trace, devices=[torch.device("cpu")],
                       t_start=time.perf_counter(),
                       overrides=SMALL | extra)


def test_cell_files_are_found_by_name():
    from lyssandra_tpu_torch.solvers.lasso import feature_sign

    c = spec.Cell(CELL)
    cfg = c.config
    assert cfg["name"] == "lasso-c4" and cfg["reduced"] == []
    assert (cfg["p"], cfg["K"], cfg["lam"], cfg["n_encode"], cfg["block"],
            cfg["pool_seeds"]) == (192, 1024, 0.15, 100000, 2048,
                                   [2, 3, 4, 5])
    # the encoder runs at feature_sign's defaults
    defaults = feature_sign.__kwdefaults__
    for key in ("max_active", "max_iter", "max_inner", "polish"):
        assert cfg[key] == defaults[key], key
    online = spec.Cell("online-c4.stream").config
    for key in ("images", "image", "patch", "n_train", "n_holdout",
                "data_seed", "epoch_seed", "K", "lam", "batch_size",
                "n_sweeps", "beta", "init_seed"):
        assert cfg[key] == online[key], key
    assert c.traffic["entry"] == "lasso_encode"
    assert hasattr(c.entry_module(), "Entry")
    assert callable(c.reference().lasso) and callable(c.reference().learn)
    names = {m["name"] for m, _ in c.metrics(True)}
    assert names == {"mfu.lasso", "k6_roofline.lasso", "device_idle.lasso",
                     "fs_syncs.lasso", *SPAN_METRICS}
    assert [m["name"] for m, _ in c.metrics(False)] == ["task_s", "setup_s"]


def test_sound_run_is_correct_and_traced_run_reads_the_spans():
    res = run(trace=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    m = res["metrics"]
    for n in ("mfu.lasso", "fs_syncs.lasso", "loop_s.lasso",
              "polish_s.lasso"):
        assert m[n]["value"] > 0, n
    # K6 runs only on the card
    assert "k6_roofline.lasso" not in m
    assert res["checks"]["lanes_missing"]["value"] == 0


def test_polished_run_is_correct(monkeypatch):
    lasso = importlib.import_module(LASSO)
    fista, calls = lasso.fista, []

    def counted(*a, **kw):
        calls.append(1)
        return fista(*a, **kw)

    monkeypatch.setattr(lasso, "fista", counted)
    res = run(trace=True, **FEW_ITERATIONS)
    assert res["correct"], res["checks"]
    assert calls                     # FISTA-500 ran in some block
    assert res["metrics"]["polish_s.lasso"]["value"] > 0


def _zero_lanes(orig):
    """Every hundredth lane's codes zeroed."""
    def encode(self, X, D, **kw):
        G = orig(self, X, D, **kw).clone()
        G[:, ::100] = 0.0
        return G
    return encode


def _swap_blocks(orig):
    """The codes of the first two blocks handed to each other."""
    def encode(self, X, D, **kw):
        G = orig(self, X, D, **kw).clone()
        b = self.block
        G[:, :2 * b] = torch.cat([G[:, b:2 * b], G[:, :b]], dim=1)
        return G
    return encode


def _off_lam(orig):
    """The lasso solved at lam 1% too large."""
    return lambda D, X, lam, **kw: orig(D, X, 1.01 * lam, **kw)


def _no_polish(orig):
    return lambda D, X, lam, res: res


FAULTS = {
    "1% of lanes zeroed": (ENCODER, "SparseEncoder.encode", _zero_lanes, {}),
    "two blocks swapped": (ENCODER, "SparseEncoder.encode", _swap_blocks,
                           {}),
    "lam off by 1%": (ENCODER, "feature_sign", _off_lam, {}),
    "polish skipped": (LASSO, "_fs_polish", _no_polish, FEW_ITERATIONS),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    module, name, make, extra = FAULTS[fault]
    owner = importlib.import_module(module)
    path = name.split(".")
    for part in path[:-1]:
        owner = getattr(owner, part)
    monkeypatch.setattr(owner, path[-1], make(getattr(owner, path[-1])))
    res = run(**extra)
    assert not res["correct"], res["checks"]


def test_control_fails_a_limit():
    limits = spec.Cell(CELL, overrides=SMALL).limits()
    nums = control.control_numbers(CELL, 2**31 + 11,
                                   [torch.device("cpu")], overrides=SMALL)
    assert set(nums) == set(limits)
    assert control.failed(nums, limits), nums


def test_encode_work_by_hand():
    # p=2, K=3, lanes with 1 and 2 nonzeros: A0 2pK a lane; the first test
    # K a lane; the step that leaves a atoms 3K + 2Ka + 3a^2; X, D, Gamma
    flops, nbytes = lasso_encode_work.call(2, 3, [1, 2])
    assert flops == 2 * 12 + 2 * 3 + (9 + 6 + 3) + (9 + 6 + 3) + (
        9 + 12 + 12)
    assert nbytes == 4 * (2 * 2 + 2 * 3 + 3 * 2)


def test_cold_starts_by_hand():
    # 7 lanes in blocks of 4: a full block of the sample [0, 2, 5, 0] and
    # a block of 3 real lanes ([0, 2, 5]) and one of padding (no atom)
    flops, nbytes = lasso_encode_work.cold_starts(10, 3, 4, [0, 2, 5], 7, 6)
    f1, b1 = lasso_work.fs_cold_kernel(10, 3, [0, 2, 5, 0], 6)
    f2, b2 = lasso_work.fs_cold_kernel(10, 3, [0, 2, 5, 0], 6)
    assert (flops, nbytes) == (f1 + f2, b1 + b2)
    f3, _ = lasso_work.fs_cold_kernel(10, 3, [0, 0, 0, 0], 6)
    assert f3 == 40 and f1 > f3
