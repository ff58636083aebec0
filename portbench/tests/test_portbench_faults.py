"""Whole runs of each cell on the CPU at small sizes (the program's plain
versions, no look for a chip): a sound run comes out correct, and a run
with the timed path broken underneath comes out not correct, once for
each fault the cell can have."""

import importlib
import time

import pytest
import torch

from portbench.core import harness, spec

SMALL = {
    "bomp-k1024.bulk": {"patches_per_request": 4096, "block": 2048,
                        "sample_lanes": 512},
    "denoise-512.dct": {"image": 64, "pool": 4, "warmup_requests": 4},
    "denoise-512.adaptive": {"image": 64, "n_train": 2000, "n_iter": 2,
                             "K": 64, "pool": 2},
}


def run(cell, seed=2**31 + 11):
    return harness.run(cell, seed, 0.2, False, devices=[torch.device("cpu")],
                       t_start=time.perf_counter(), overrides=SMALL[cell])


def mod(name):
    return importlib.import_module("lyssandra_tpu_torch." + name)


def half_codes(orig):
    """An OMP that leaves the second half of its lanes uncoded."""
    def f(D, X, *a, **kw):
        res = orig(D, X, *a, **kw)
        n = X.shape[1] // 2
        return type(res)(*(torch.cat([t[:n], torch.zeros_like(t[n:])])
                           for t in res))
    return f


def altered_codes(orig):
    """An OMP whose first coefficient of every lane is 1% off."""
    def f(D, X, *a, **kw):
        res = orig(D, X, *a, **kw)
        g = res.gamma.clone()
        g[:, 0] *= 1.01
        return res._replace(gamma=g)
    return f


def half_dense(orig):
    """The denoiser's coder with the second half of the patches left
    uncoded."""
    def f(D, Xc, **kw):
        G = orig(D, Xc, **kw)
        G[:, G.shape[1] // 2:] = 0
        return G
    return f


def altered_image(orig):
    return lambda *a, **kw: orig(*a, **kw) + 0.5


def unchanged_sweep(X, D, Gamma, *a, **kw):
    return D.clone(), Gamma.clone()


def half_sweep(orig):
    """The atom sweep over the first half of the signals only."""
    def f(X, D, Gamma, *a, **kw):
        n = X.shape[1] // 2
        D2, G2 = orig(X[:, :n], D, Gamma[:, :n], *a, **kw)
        return D2, torch.cat([G2, Gamma[:, n:]], dim=1)
    return f


FAULTS = {
    "bomp-k1024.bulk": {
        "half the batch left out": ("solvers.greedy", "batch_omp",
                                    half_codes),
        "an answer altered": ("solvers.greedy", "batch_omp", altered_codes),
    },
    "denoise-512.dct": {
        "half the batch left out": ("apps.denoise", "_eps_two_phase",
                                    half_dense),
        "an answer altered": ("apps.denoise", "weighted_reconstruct",
                              altered_image),
    },
    "denoise-512.adaptive": {
        "a step that returns its state unchanged": (
            "dict_learning.ksvd", "ksvd_atom_update",
            lambda orig: unchanged_sweep),
        "half the batch left out": ("dict_learning.ksvd",
                                    "ksvd_atom_update", half_sweep),
        "an answer altered": ("apps.denoise", "weighted_reconstruct",
                              altered_image),
    },
}


CELLS = sorted(w["name"] for w in spec.benchmark()["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in sorted(FAULTS[c])])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    where, name, make = FAULTS[cell][fault]
    m = mod(where)
    monkeypatch.setattr(m, name, make(getattr(m, name)))
    res = run(cell)
    assert not res["correct"], res["checks"]


def test_adaptive_check_sees_every_iteration():
    """The adaptive check follows the program's K-SVD through the names
    ``ksvd_step`` / ``ksvd_step_compact``: a fit has to call one of them
    once an iteration, or the cell cannot be checked."""
    ksvd = mod("dict_learning.ksvd")
    assert all(callable(getattr(ksvd, n, None))
               for n in ("ksvd_step", "ksvd_step_compact"))
    res = run("denoise-512.adaptive")
    assert res["checks"]["iterations_missing"]["value"] == 0, res["checks"]
