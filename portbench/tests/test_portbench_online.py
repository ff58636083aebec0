"""Config 4's cells, ``online-c4.fit`` and ``online-c4.stream``, on the CPU
at a small size: their files are found by name, a sound whole run is
correct and a run with the learner broken underneath is not, once for
each fault; the frozen colour patches equal the program's; the reference's
lasso and the counted work against hand-worked cases.  On the card
``test_portbench_card.py`` holds each cell's control to its limits."""

import importlib
import time

import numpy as np
import pytest
import torch

from portbench.core import harness, spec
from portbench.reference import online as ref
from portbench.yardstick import color, lasso_work

CELLS = ("online-c4.fit", "online-c4.stream")
SMALL = {"image": 32, "patch": 2, "n_train": 400, "n_holdout": 64, "K": 24,
         "batch_size": 64, "pool": 2, "sample_span": 2, "trace_requests": 2}
ONLINE = "lyssandra_tpu_torch.dict_learning.online"


def run(cell, trace=False, seed=2**31 + 11):
    return harness.run(cell, seed, 0.2, trace, devices=[torch.device("cpu")],
                       t_start=time.perf_counter(), overrides=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = spec.Cell(cell)
    assert c.config["name"] == "online-c4" and c.config["reduced"] == []
    assert c.traffic["entry"] == "online"
    assert c.traffic["mode"] == cell.split(".")[1]
    assert hasattr(c.entry_module(), "Entry")
    assert callable(c.reference().lasso)
    names = {m["name"] for m, _ in c.metrics(True)}
    assert {"code_s.online", "sweep_s.online", "fs_syncs.online",
            "launches.learning", "device_idle.learning",
            "mfu.learning"} <= names
    assert ("k6_roofline.online" in names) == (cell == "online-c4.stream")
    assert [m["name"] for m, _ in c.metrics(False)] == ["task_s", "setup_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_traced_run_reads_the_spans(cell):
    res = run(cell, trace=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    for n in ("code_s.online", "sweep_s.online", "fs_syncs.online",
              "mfu.learning"):
        assert res["metrics"][n]["value"] > 0, n
    assert res["checks"]["minibatches_missing"]["value"] == 0


def _no_projection(orig):
    def sweep(D, A, B, n_sweeps):
        D = D.clone()
        akk = torch.diagonal(A).clamp_min(1e-10)
        for k in range(D.shape[1]):
            D[:, k] = D[:, k] + torch.addmv(B[:, k], D, A[:, k],
                                            alpha=-1.0) / akk[k]
        return D
    return sweep


def _dropped_beta(orig):
    """The statistics' old term beta A left out."""
    def step(D, A, B, Xb, *a, **kw):
        return orig(D, torch.zeros_like(A), B, Xb, *a, **kw)
    return step


def _swap(Gamma):
    Gamma = Gamma.clone()
    Gamma[:, [0, 1]] = Gamma[:, [1, 0]]
    return Gamma


def _swapped_codes(orig):
    """Lanes 0 and 1 handed each other's codes."""
    return lambda *a, **kw: _swap(orig(*a, **kw))


def _stale_stream(orig):
    """partial_fit's step keeps the dictionary it started from."""
    def step(state, Xb, cfg, **kw):
        new, Gamma = orig(state, Xb, cfg, **kw)
        return new._replace(D=state.D), Gamma
    return step


def _stale_fit(orig):
    """fit's chunk keeps the dictionary it started from."""
    def chunk(D, *a, **kw):
        return (D,) + tuple(orig(D, *a, **kw)[1:])
    return chunk


def _short_holdout(orig):
    """The holdout metric's FISTA stopped at 30 of its 300 iterations."""
    return lambda D, Xh, lam, n_iter=300: orig(D, Xh, lam, n_iter=30)


FAULTS = {
    "online-c4.fit": {
        "sweep without the projection": ("_dict_update_body",
                                         _no_projection),
        "beta A dropped": ("minibatch_update", _dropped_beta),
        "a lane's codes swapped": ("_code_batch", _swapped_codes),
        "dictionary left stale": ("_online_chunk", _stale_fit),
        "holdout metric cut short": ("holdout_objective", _short_holdout),
    },
    "online-c4.stream": {
        "sweep without the projection": ("_dict_update_body",
                                         _no_projection),
        "beta A dropped": ("minibatch_update", _dropped_beta),
        "a lane's codes swapped": ("feature_sign", _swapped_codes),
        "dictionary left stale": ("online_dl_step", _stale_stream),
    },
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in sorted(FAULTS[c])])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    name, make = FAULTS[cell][fault]
    m = importlib.import_module(ONLINE)
    monkeypatch.setattr(m, name, make(getattr(m, name)))
    res = run(cell)
    assert not res["correct"], res["checks"]


def test_a_program_without_the_step_stops_the_run(monkeypatch):
    # a program that predates minibatch_update: the entry refuses at set-up
    m = importlib.import_module(ONLINE)
    monkeypatch.delattr(m, "minibatch_update")
    with pytest.raises(RuntimeError, match="minibatch_update"):
        run("online-c4.stream")


def test_frozen_patches_equal_the_programs():
    from lyssandra_tpu_torch.utils.datasets import (
        patch_dataset, synthetic_color_image,
    )

    kinds = ("texture", "mix", "smooth", "edges")
    imgs = [synthetic_color_image(k, 32, seed=s)
            for s, k in enumerate(kinds)]
    mine = [color.synthetic_color_image(k, 32, seed=s)
            for s, k in enumerate(kinds)]
    for a, b in zip(imgs, mine):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(patch_dataset(imgs, p=4, n_patches=203,
                                                seed=1),
                                  color.patches(mine, 4, 203, 1))
    cfg = {"images": list(kinds), "image": 32, "patch": 4, "n_train": 150,
           "n_holdout": 53, "data_seed": 1}
    X = color.unit_patches(cfg)
    assert X.dtype == np.float32 and X.shape == (48, 203)
    np.testing.assert_allclose(np.linalg.norm(X, axis=0), 1.0, rtol=1e-6)


def test_reference_lasso_against_every_sign_pattern():
    # p=3, K=4: the optimum is the best of the sign-consistent solutions of
    # the 3^4 patterns' normal equations, worked out one by one
    rng = np.random.default_rng(5)
    D = rng.standard_normal((3, 4))
    D /= np.linalg.norm(D, axis=0)
    X = rng.standard_normal((3, 6))
    lam = 0.3
    G, done = ref.lasso(torch.from_numpy(D), torch.from_numpy(X), lam)
    assert bool(done.all())
    for n in range(X.shape[1]):
        best = float(X[:, n] @ X[:, n])
        for pat in np.ndindex(3, 3, 3, 3):
            th = np.array(pat) - 1.0
            S = th != 0
            if not S.any():
                continue
            Ds = D[:, S]
            g = np.linalg.solve(Ds.T @ Ds, Ds.T @ X[:, n] - lam * th[S] / 2)
            if np.all(np.sign(g) == th[S]):
                r = X[:, n] - Ds @ g
                best = min(best, r @ r + lam * np.abs(g).sum())
        got = float(ref.objective(torch.from_numpy(D),
                                  torch.from_numpy(X[:, n:n + 1]),
                                  G[:, n:n + 1], lam))
        assert got == pytest.approx(best, rel=1e-12)


def test_k6_work_by_hand():
    # K=10, tun=3: lanes with optima of 0, 2 and 5 atoms run 0, 2 and 3
    # steps; the step that leaves a atoms costs 3K + 2Ka + 3a^2
    flops, nbytes = lasso_work.fs_cold_kernel(10, 3, [0, 2, 5], 6)
    steps = {a: 30 + 20 * a + 3 * a * a for a in (1, 2, 3)}
    assert flops == 3 * 10 + steps[1] + steps[2] + sum(steps.values())
    assert nbytes == 4 * (2 * 3 * 10 + 10 * 6) + 13 * 3 * 3 + 3


def test_task_work_by_hand():
    # p=2, K=3, two lanes with 1 and 2 nonzeros: A0 2pK a lane, the
    # statistics 2s^2 + 2ps, the objective 2ps, the sweep 2pK^2
    assert lasso_work.minibatch(2, 3, [1, 2]) == 24 + 2 + 8 + 8 + 16 + 36
    assert lasso_work.holdout(2, 3, 5, 7) == 60 + 17 * 24 + 7 * 24 * 5
    flops, nbytes = lasso_work.task(2, 3, [[1, 2]], 5, 7)
    assert flops == 94 + 60 + 408 + 840
    assert nbytes == 4 * (2 * 7 + 4 * 6 + 2 * 9)
