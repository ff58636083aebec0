"""The lasso encoder (``SparseEncoder("lasso")``) against the benchmark's
plain reference of config 4's coding (``portbench/configs/lasso-c4.py``,
float64, no import of the port) on the CPU at a small size: p = 12 (2x2x3
patches of the colour stand-ins), K = 24 learned by the reference's plain
online learner as the cell learns its dictionary, lam = 0.15, N = 600 in
blocks of 128, so the last block is padded.  The codes are held by their
objective against the reference's optimum and by the KKT conditions, to
the cell's own limits; each fault the cell plants reads past them.
``feature_sign``'s spans ``lyssa.fs.loop`` and ``lyssa.fs.polish`` carry
the counts the benchmark reads, nest once each, and leave ``host_syncs()``
as it is.  CPU only; no JAX."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.solvers.lasso import host_syncs
from lyssandra_tpu_torch.utils import clear_spans, spans
from portbench.core.spec import load_module
from portbench.yardstick import color

tlasso = importlib.import_module("lyssandra_tpu_torch.solvers.lasso")

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parent.parent / "portbench"
REF = load_module(BENCH / "configs" / "lasso-c4.py", "lasso_c4_reference")
LIMITS = json.loads((BENCH / "workloads" / "lasso-c4.encode.json")
                    .read_text())["limits"]
LAM, K, N, BLOCK = 0.15, 24, 600, 128
CFG = {"lam": LAM, "K": K, "batch_size": 64, "epoch_seed": 0,
       "init_seed": 0, "beta": 1.0, "n_sweeps": 1}
KINDS = ("texture", "mix", "smooth", "edges")


def _unit(X):
    X = X.astype(np.float32)
    return torch.from_numpy(X / np.linalg.norm(X, axis=0, keepdims=True))


@pytest.fixture(scope="module")
def problem():
    """(D, X): K atoms learned online by the reference from 400 training
    patches, cast to float32, and N patches of another draw."""
    imgs = [color.synthetic_color_image(k, 32, seed=s)
            for s, k in enumerate(KINDS)]
    train = _unit(color.patches(imgs, 2, 400, 1))
    D = REF.learn(train, CFG)
    assert D.dtype == torch.float64 and D.shape == (12, K)
    return D.to(torch.float32).contiguous(), _unit(
        color.patches(imgs, 2, N, 2))


@pytest.fixture(autouse=True)
def empty_store():
    clear_spans()
    yield
    clear_spans()


def encode(D, X, lam=LAM, **params):
    return lt.SparseEncoder("lasso", {"lam": lam, **params}, block=BLOCK,
                            device="cpu").encode(X, D)


def numbers(D, X, Gamma):
    """The cell's numbers of codes Gamma (K, n) of X, over every lane."""
    finite = torch.isfinite(Gamma).all(dim=0)
    kkt = REF.kkt(D, X, Gamma, CFG)
    G_ref, done = REF.lasso(D, X, CFG)
    assert bool(done.all())
    f_ref = REF.objective(D, X, G_ref, CFG)
    obj = (REF.objective(D, X, Gamma, CFG) - f_ref) / f_ref
    return {"lanes_missing": float(X.shape[1] - int(finite.sum())),
            "kkt_max": float(kkt.max()), "kkt_median": float(kkt.median()),
            "obj_gap_max": float(obj.max()),
            "obj_gap_median": float(obj.median())}


def over(nums):
    return sorted(k for k, v in nums.items() if not v <= LIMITS[k])


def test_encoder_is_held_to_the_cells_limits(problem):
    D, X = problem
    Gamma = encode(D, X)
    assert Gamma.shape == (K, N) and Gamma.dtype == torch.float32
    nums = numbers(D, X, Gamma)
    assert over(nums) == [], nums
    # the padded block's lanes are coded as the others are
    assert nums["obj_gap_max"] < 1e-6


def test_reference_optimum_holds_its_conditions(problem):
    D, X = problem
    G_ref, done = REF.lasso(D, X, CFG)
    assert bool(done.all()) and G_ref.dtype == torch.float64
    assert float(REF.kkt(D, X, G_ref, CFG).max()) < 1e-8
    # the control, float32, is looser
    G_c, _ = REF.lasso(D, X, CFG, control=True)
    assert G_c.dtype == torch.float32
    assert float(REF.kkt(D, X, G_c, CFG).max()) > 1e-6


def _zeroed(D, X):
    G = encode(D, X).clone()
    G[:, ::100] = 0.0
    return G


def _swapped(D, X):
    G = encode(D, X)
    return torch.cat([G[:, BLOCK:2 * BLOCK], G[:, :BLOCK], G[:, 2 * BLOCK:]],
                     dim=1)


def _off_lam(D, X):
    return encode(D, X, lam=1.01 * LAM)


def _unpolished(D, X):
    # 6 outer iterations leave lanes for the polish, which is skipped
    return encode(D, X, max_iter=6)


FAULTS = {"1% of lanes zeroed": _zeroed, "two blocks swapped": _swapped,
          "lam off by 1%": _off_lam, "polish skipped": _unpolished}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_reads_not_correct(problem, fault, monkeypatch):
    D, X = problem
    if fault == "polish skipped":
        # with the polish those lanes meet the limits
        assert over(numbers(D, X, encode(D, X, max_iter=6))) == []
        monkeypatch.setattr(tlasso, "_fs_polish",
                            lambda D, X, lam, res: res)
    assert over(numbers(D, X, FAULTS[fault](D, X))), fault


def traced(fn):
    clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, spans()


def named(records, name):
    return [(i, r) for i, r in enumerate(records) if r.name == name]


def count_fista(monkeypatch):
    """The list that gets one entry a FISTA-500 polish run."""
    calls = []
    fista = tlasso.fista

    def counted(*a, **kw):
        calls.append(1)
        return fista(*a, **kw)

    monkeypatch.setattr(tlasso, "fista", counted)
    return calls


@pytest.mark.parametrize("max_iter", [6, 100], ids=["polish", "no_polish"])
def test_loop_and_polish_spans_carry_their_counts(problem, max_iter,
                                                  monkeypatch):
    D, X = problem
    Xb = X[:, :BLOCK]
    res = tlasso.feature_sign(D, Xb, LAM, max_iter=max_iter,
                              full_result=True, polish=False)
    lanes = int((~res.done | res.overflow).sum())
    assert (lanes > 0) == (max_iter == 6)
    # the reads of each segment, counted around _fs_loop
    segs = []
    loop = tlasso._fs_loop

    def counted(*a, **kw):
        s0 = host_syncs()
        out = loop(*a, **kw)
        segs.append(host_syncs() - s0)
        return out

    monkeypatch.setattr(tlasso, "_fs_loop", counted)
    fistas = count_fista(monkeypatch)
    s0 = host_syncs()
    _, recs = traced(lambda: tlasso.feature_sign(D, Xb, LAM,
                                                 max_iter=max_iter))
    syncs = host_syncs() - s0
    (_, lp), = named(recs, "lyssa.fs.loop")
    (_, pol), = named(recs, "lyssa.fs.polish")
    # the plain loop on the CPU: fused 0
    assert lp.attrs == {"syncs": sum(segs), "segments": len(segs),
                        "fused": 0}
    assert pol.attrs == {}
    assert len(fistas) == int(lanes > 0)
    # the polish's gate is one read; the warm start's reads are outside
    assert lp.attrs["syncs"] + 1 <= syncs
    assert lp.end_ns <= pol.start_ns


def test_spans_nest_under_each_block(problem):
    D, X = problem
    _, recs = traced(lambda: encode(D, X))
    blocks = [i for i, _ in named(recs, "lyssa.encode.block")]
    assert len(blocks) == -(-N // BLOCK)
    for name in ("lyssa.fs.loop", "lyssa.fs.polish"):
        found = named(recs, name)
        assert sorted(r.parent for _, r in found) == blocks, name


@pytest.mark.parametrize("max_iter", [6, 100], ids=["polish", "no_polish"])
def test_spans_leave_host_syncs_and_codes_alone(problem, max_iter,
                                                monkeypatch):
    D, X = problem
    fistas = count_fista(monkeypatch)

    def run():
        s0 = host_syncs()
        G = encode(D, X, max_iter=max_iter)
        return G, host_syncs() - s0

    G_off, n_off = run()
    assert spans() == []
    (G_on, n_on), recs = traced(run)
    assert n_on == n_off
    assert torch.equal(G_on, G_off)
    loops = named(recs, "lyssa.fs.loop")
    polishes = named(recs, "lyssa.fs.polish")
    # every read is the loop's, the polish gate's or the warm start's
    assert sum(r.attrs["syncs"] for _, r in loops) + len(polishes) <= n_on
    assert len(polishes) == -(-N // BLOCK)
    assert (len(fistas) > 0) == (max_iter == 6)


def test_overflow_resolve_opens_its_own_loop_span():
    # 40 Gaussian atoms in 24 dimensions at a small lam: lanes take more
    # than the 16 slots that auto_capacity runs at, and are re-solved
    g = torch.Generator().manual_seed(3)
    D = torch.randn(24, 40, generator=g, dtype=torch.float64)
    D = (D / D.norm(dim=0)).to(torch.float32)
    X = torch.randn(24, 32, generator=g)
    lam = 0.002
    res = tlasso.feature_sign(D, X, lam, auto_capacity=True, polish=False,
                              full_result=True)
    first = tlasso.feature_sign(D, X, lam, max_active=16, polish=False,
                                full_result=True)
    assert bool(first.overflow.any()) and not bool(res.overflow.any())
    s0 = host_syncs()
    _, recs = traced(lambda: tlasso.feature_sign(
        D, X, lam, auto_capacity=True, polish=False))
    syncs = host_syncs() - s0
    loops = named(recs, "lyssa.fs.loop")
    assert len(loops) == 2
    ids = {i for i, _ in loops}
    # neither loop holds the other: their times and reads add up once
    assert all(r.parent not in ids for _, r in loops)
    (_, outer), (_, inner) = sorted(loops, key=lambda e: e[1].start_ns)
    assert outer.end_ns <= inner.start_ns
    assert outer.attrs["syncs"] + inner.attrs["syncs"] < syncs
