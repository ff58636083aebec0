"""Config 2's cell, ``ksvd-c2.fit``, on the CPU at a small size: its files
are found by name, a sound whole run is correct and a run with the learner
broken underneath is not, once for each fault; the reference's draws
equal the program's bit for bit, and its coding and sweep split from
``reference/ksvd.py``'s iteration give that iteration bit for bit.  On
the card the control fails the cell's check on each of the four training
sets at the cell's size."""

import importlib
import time

import numpy as np
import pytest
import torch

from portbench.core import control, harness, spec
from portbench.reference import ksvd as ref_ksvd
from portbench.reference.omp import dense, omp

CELL = "ksvd-c2.fit"
# 4 atoms replaced in the first iteration at this size
SMALL = {"image": 64, "n_train": 1500, "K": 128, "n_iter": 3, "pool": 2}
KSVD = "lyssandra_tpu_torch.dict_learning.ksvd"


def run(trace=False, seed=2**31 + 11):
    return harness.run(CELL, seed, 0.2, trace, devices=[torch.device("cpu")],
                       t_start=time.perf_counter(), overrides=SMALL)


def test_cell_files_are_found_by_name():
    c = spec.Cell(CELL)
    assert c.config["name"] == "ksvd-c2" and c.config["reduced"] == []
    assert (c.config["K"], c.config["T"], c.config["n_iter"],
            c.config["n_train"]) == (512, 8, 20, 50000)
    assert c.traffic["entry"] == "ksvd_fit"
    assert hasattr(c.entry_module(), "Entry")
    assert callable(c.reference().from_codes)
    names = {m["name"] for m, _ in c.metrics(True)}
    assert names == {"mfu.learning", "launches.learning",
                     "device_idle.learning", "code_s.learning",
                     "sweep_s.learning", "sweep_replays.learning",
                     "k1_roofline.learning"}
    assert [m["name"] for m, _ in c.metrics(False)] == ["task_s", "setup_s"]


def test_sound_run_is_correct_and_traced_run_reads_the_spans():
    res = run(trace=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    for n in ("code_s.learning", "sweep_s.learning", "mfu.learning"):
        assert res["metrics"][n]["value"] > 0, n
    # every sweep runs eager on the CPU; K1 runs only on the card
    assert res["metrics"]["sweep_replays.learning"]["value"] == 0
    assert "k1_roofline.learning" not in res["metrics"]
    assert res["checks"]["iterations_missing"]["value"] == 0


def _skipped_sweep(orig):
    return lambda X, D, Gamma, *a, **kw: (D.clone(), Gamma.clone())


def _half_sweep(orig):
    """The sweep over the first half of the atoms only."""
    def f(X, D, Gamma, *a, **kw):
        D2, G2 = orig(X, D, Gamma, *a, **kw)
        h = D.shape[1] // 2
        return (torch.cat([D2[:, :h], D[:, h:]], dim=1),
                torch.cat([G2[:h], Gamma[h:]]))
    return f


def _altered_codes(orig):
    """An OMP whose largest coefficient of every lane is 1% off."""
    def f(D, X, *a, **kw):
        G = orig(D, X, *a, **kw).clone()
        top = G.abs().argmax(dim=0, keepdim=True)
        G.scatter_(0, top, 1.01 * G.gather(0, top))
        return G
    return f


def _no_replacement(orig):
    def f(X, D, err, use, *a, **kw):
        return D, torch.zeros(D.shape[1], dtype=torch.bool, device=D.device)
    return f


def _one_iteration_short(orig):
    def fit(self, X, D0=None, n_iter=None, resume=False):
        return orig(self, X, D0, self.cfg.n_iter - 1, resume)
    return fit


FAULTS = {
    "sweep skipped": (KSVD, "ksvd_atom_update", _skipped_sweep),
    "half the sweep": (KSVD, "ksvd_atom_update", _half_sweep),
    "codes altered": ("lyssandra_tpu_torch.solvers.greedy", "batch_omp",
                      _altered_codes),
    "replacement dropped": (KSVD, "replacement_atoms", _no_replacement),
}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["iteration skipped"])
def test_fault_is_not_correct(fault, monkeypatch):
    if fault == "iteration skipped":
        m = importlib.import_module(KSVD).KSVDLearner
        monkeypatch.setattr(m, "fit", _one_iteration_short(m.fit))
    else:
        where, name, make = FAULTS[fault]
        m = importlib.import_module(where)
        monkeypatch.setattr(m, name, make(getattr(m, name)))
    res = run()
    assert not res["correct"], res["checks"]


def test_draws_equal_the_programs():
    from lyssandra_tpu_torch.ops.dictionaries import init_dictionary
    from lyssandra_tpu_torch.utils import patch_dataset
    from portbench.yardstick import generate

    c = spec.Cell(CELL, overrides=SMALL)
    ref = c.reference()
    imgs = generate.clean_images(c.config["images"], c.config["image"])
    for s in (0, 3):
        X = ref.train_patches(c.config, s, torch.device("cpu"))
        want = patch_dataset(imgs, p=8, n_patches=SMALL["n_train"], seed=s)
        np.testing.assert_array_equal(X.numpy(), want.astype(np.float32))
    # flat patches (zero columns) are among the draw's, so the noise that
    # stands in for them is drawn too
    X[:, :40] = 0.0
    D = init_dictionary(X, 512, "data", 0, device="cpu")
    assert torch.equal(ref.dictionary(X, c.config | {"K": 512}), D)


def test_coding_and_sweep_split_give_the_iteration():
    rng = np.random.default_rng(3)
    cfg = spec.Cell(CELL).config
    X = torch.from_numpy(rng.standard_normal((16, 300)))
    X[15] = 0.0
    D = torch.from_numpy(rng.standard_normal((16, 40)))
    D[15], D[:, 9] = 0.0, 0.0
    D[15, 9] = 1.0          # the one atom off the signals' span: unused
    D = D / torch.linalg.vector_norm(D, dim=0)
    ref = spec.Cell(CELL).reference()
    want, nsel = ref_ksvd.ksvd_iteration(X, D, T=4, eps=None)
    idx, gamma, _, _ = omp(D, X, 4)
    got, stats = ref.from_codes(X, D, dense(idx, gamma, 40),
                                cfg | {"T": 4})
    assert torch.equal(got, want)
    assert int(stats[3]) >= 1 and bool((nsel == 4).all())


def _seeds_by_set():
    """A seed whose followed task is on each of the four training sets."""
    entry = spec.Cell(CELL).entry_module().Entry
    cell = spec.Cell(CELL)
    found = {}
    seed = 2**31 + 200
    while len(found) < cell.traffic["pool"]:
        e = entry(cell, seed, [torch.device("cpu")])
        found.setdefault(int(e.order[e.follow_index]), seed)
        seed += 1
    return [found[s] for s in sorted(found)]


def test_seeds_reach_every_training_set():
    assert len(_seeds_by_set()) == 4


@pytest.mark.card
@pytest.mark.parametrize("which", range(4))
def test_control_fails_the_check_on_each_set(card, which):
    limits = spec.Cell(CELL).limits()
    nums = control.control_numbers(CELL, _seeds_by_set()[which], [card])
    assert control.failed(nums, limits), nums
