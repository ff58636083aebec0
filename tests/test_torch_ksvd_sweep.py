"""K-SVD's sweep kernel's route on the CPU: the dense sweep
``ksvd._sweep(..., 1, n_power)``, the kernel's plain version, holds the
float64 sweep and keeps what the kernel's design rests on (each code row's
support, atoms without users and their rows, unit atoms, its inputs) for
atoms without users, an atom every lane uses, duplicate atoms, one and three
power steps; the wrapper runs it on CPU tensors; the kernel's envelope
(``takes``, ``smem_bytes``) accepts and refuses as it should; and
``ksvd_atom_update`` hands the sweep to the wrapper where ``takes`` holds
and keeps its graph path where it does not (through stand-ins: the kernel
itself runs only on the card, in ``tests/test_torch_ksvd_sweep_card.py``)."""

import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import _launch, cuda_ksvd_sweep
from lyssandra_tpu_torch.ops.cuda_ksvd_sweep import (
    ksvd_sweep_fused,
    smem_bytes,
    takes,
)
from lyssandra_tpu_torch.utils import clear_spans, spans

tksvd = importlib.import_module("lyssandra_tpu_torch.dict_learning.ksvd")

# float32 against the float64 sweep at these sizes: a few eps of an atom
# (unit norm) and of the largest code of a column
ATOM_TOL, CODE_TOL = 1e-5, 1e-4


def problem(seed, case, p=12, K=24, N=300, T=3):
    """X = D Gamma plus noise, with T random atoms a lane.  ``case``:
    'plain'; 'no-users' (atoms 1 and 5 unused, atom 0 used by one lane);
    'every-lane' (atom 2 used by every lane); 'duplicates' (atoms 3 and 4
    equal, both used)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((p, K))
    if case == "duplicates":
        D[:, 4] = D[:, 3]
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    G = np.zeros((K, N))
    for n in range(N):
        G[rng.choice(K, T, replace=False), n] = rng.standard_normal(T)
    if case == "no-users":
        G[[0, 1, 5]] = 0.0
        G[0, 7] = 0.5
    elif case == "every-lane":
        G[2] = rng.standard_normal(N)
    elif case == "duplicates":
        G[3, ::3] = G[4, 1::3] = 0.7
    X = D @ G + 0.05 * rng.standard_normal((p, N))
    return [torch.as_tensor(v, dtype=torch.float32) for v in (X, D, G)]


def gaps(got, want):
    """The widest atom distance and the widest code gap over its column's
    largest code."""
    atoms = torch.linalg.vector_norm(got[0].double() - want[0].double(),
                                     dim=0)
    scale = want[1].double().abs().amax(dim=0).clamp_min(1e-12)
    codes = (got[1].double() - want[1].double()).abs() / scale
    return float(atoms.max()), float(codes.max())


SEEDS = {"plain": 10, "no-users": 20, "every-lane": 30, "duplicates": 40}


@pytest.mark.parametrize("n_power", [1, 3])
@pytest.mark.parametrize("case", ["plain", "no-users", "every-lane",
                                  "duplicates"])
def test_the_plain_sweep_keeps_what_the_kernel_rests_on(case, n_power):
    """The kernel works on each atom's users alone and leaves an atom
    without users as it is: the dense sweep, its plain version, must keep
    every code row's support and such atoms and rows bit for bit."""
    X, D, G = problem(SEEDS[case] + n_power, case)
    before = [t.clone() for t in (X, D, G)]
    got = tksvd._sweep(X, D, G, 1, n_power)
    want = tksvd._sweep(X.double(), D.double(), G.double(), 1, n_power)
    atom_gap, code_gap = gaps(got, want)
    assert atom_gap <= ATOM_TOL and code_gap <= CODE_TOL
    for t, t0 in zip((X, D, G), before):
        assert torch.equal(t, t0)
    assert torch.equal(got[1] != 0, G != 0)          # supports kept
    unused = (G == 0).all(dim=1)
    assert torch.equal(got[0][:, unused], D[:, unused])
    assert torch.equal(got[1][unused], G[unused])
    norms = torch.linalg.vector_norm(got[0][:, ~unused], dim=0)
    assert float((norms - 1).abs().max()) <= 1e-6
    if case == "no-users":
        assert int(unused.sum()) == 2 and not unused[0]


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    X, D, G = problem(3, "plain")
    assert not takes(X, D, G, 1, 1)
    lt.reset_launch_counts()
    got = ksvd_sweep_fused(X, D, G, 1)
    want = tksvd._sweep(X, D, G, 1, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert lt.launch_counts()["ksvd_sweep"] == 0


def _card(*shape, dtype=torch.float32, device="cuda:0"):
    """What ``takes`` reads of a CUDA tensor, without a card."""
    return SimpleNamespace(is_cuda=True, dtype=dtype, shape=shape,
                           device=torch.device(device))


def _fits(p, N):
    return smem_bytes(p, N) <= _build.SMEM_PER_BLOCK


def _largest_fitting_N(p):
    N = 1
    while _fits(p, 2 * N):
        N *= 2
    lo, hi = N, 2 * N          # fits at lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _fits(p, mid) else (lo, mid)
    return lo


@pytest.mark.parametrize("p,K,N", [(64, 512, 50_000), (64, 256, 30_000),
                                   (1, 1, 1), (256, 20, 2000)],
                         ids=["config2", "adaptive", "smallest", "widest"])
def test_takes_the_main_shapes(p, K, N):
    assert takes(_card(p, N), _card(p, K), _card(K, N), 1, 1)
    assert takes(_card(p, N), _card(p, K), _card(K, N), 1, 3)
    assert _fits(p, N)


@pytest.mark.parametrize("case", [
    "cpu", "atom-blocks", "p-beyond-the-cap", "no-power-step", "float64",
    "two-gpus", "gamma-shape", "d-shape", "lanes-beyond-the-cluster",
    "one-cpu"])
def test_takes_refuses_outside_the_envelope(case):
    p, K, N = 64, 512, 50_000
    X, D, G = _card(p, N), _card(p, K), _card(K, N)
    B, n_power = 1, 1
    if case == "cpu":
        X, D, G = torch.zeros(p, 8), torch.zeros(p, K), torch.zeros(K, 8)
    elif case == "atom-blocks":
        B = 8
    elif case == "p-beyond-the-cap":
        p = cuda_ksvd_sweep.P_MAX
        assert takes(_card(p, N), _card(p, K), G, 1, 1)
        X, D = _card(p + 1, N), _card(p + 1, K)
    elif case == "no-power-step":
        n_power = 0
    elif case == "float64":
        G = _card(K, N, dtype=torch.float64)
    elif case == "two-gpus":
        D = _card(p, K, device="cuda:1")
    elif case == "gamma-shape":
        G = _card(K, N + 1)
    elif case == "d-shape":
        D = _card(p + 1, K)
    elif case == "lanes-beyond-the-cluster":
        N = _largest_fitting_N(p) + 1
        assert takes(_card(p, N - 1), D, _card(K, N - 1), 1, 1)
        X, G = _card(p, N), _card(K, N)
    else:
        G = torch.zeros(K, N)
    assert not takes(X, D, G, B, n_power)


def test_smem_bytes_match_the_kernels_layout():
    # two mbarriers of 8 bytes; three buffers of L = 3,128 lanes (N=50,000
    # over 16 CTAs, padded to 4) of a code row and of an atom; 2 x 16
    # slots, the CTA's sum and 16 warps' partials of p + 2 = 66 padded to
    # 68; five lists of ceil(L / 16) = 196 a warp
    assert smem_bytes(64, 50_000) == 16 + 4 * (
        3 * (3128 + 64) + (2 * 16 + 1 + 16) * 68 + 5 * 16 * 196)
    # N=333: L = 24 lanes a CTA (21 padded), 2 a warp; p + 2 = 9 padded
    # to 12
    assert smem_bytes(7, 333) == 16 + 4 * (
        3 * (24 + 8) + (2 * 16 + 1 + 16) * 12 + 5 * 16 * 2)


@pytest.mark.parametrize("p,lo,hi", [(1, 110_000, 120_000),
                                     (64, 100_000, 115_000),
                                     (256, 85_000, 95_000)])
def test_the_lanes_the_cluster_holds(p, lo, hi):
    # the cluster's shared memory caps N, the lanes, by p
    N = _largest_fitting_N(p)
    assert lo < N < hi
    assert takes(_card(p, N), _card(p, 8), _card(8, N), 1, 1)
    assert not takes(_card(p, N + 1), _card(p, 8), _card(8, N + 1), 1, 1)


def test_the_wrapper_refuses_cuda_tensors_outside_the_envelope(monkeypatch):
    X, D, G = problem(4, "plain")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(ValueError, match="kernel takes float32"):
        ksvd_sweep_fused(X.double(), D.double(), G.double(), 1)
    with pytest.raises(ValueError, match="kernel takes float32"):
        ksvd_sweep_fused(X, D, G, 0)


def traced(*x, **kw):
    """``ksvd_atom_update(*x, **kw)`` and its sweep span's attributes."""
    clear_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = tksvd.ksvd_atom_update(*x, **kw)
        recs = [r for r in spans() if r.name == "lyssa.ksvd.sweep"]
    finally:
        clear_spans()
    assert len(recs) == 1
    return out, recs[0].attrs


@pytest.mark.parametrize("kernel,atom_block,exact", [
    (True, 1, False), (True, 1, True), (False, 1, False), (False, 8, False)],
    ids=["takes", "takes-exact", "refuses", "refuses-blocks"])
def test_ksvd_atom_update_routes_by_takes(monkeypatch, kernel, atom_block,
                                          exact):
    """With the sweep posing as one on a GPU (a graph key), the kernel's
    wrapper runs where ``takes`` holds, one counted launch and no graph
    mode asked; where it does not, the graph path decides as before."""
    X, D, G = problem(5, "plain")
    asked, modes = [], []

    def takes_stand_in(X, D, Gamma, B, n_power):
        asked.append((B, n_power))
        return kernel

    def wrapper_stand_in(X, D, Gamma, n_power):
        _launch.count("ksvd_sweep")
        return tksvd._sweep(X, D, Gamma, 1, n_power)

    def mode(key):
        modes.append(key)
        return "eager", None

    monkeypatch.setattr(tksvd, "_graph_key",
                        lambda X, D, B, n_power: ("gpu", B, n_power))
    monkeypatch.setattr(cuda_ksvd_sweep, "takes", takes_stand_in)
    monkeypatch.setattr(cuda_ksvd_sweep, "ksvd_sweep_fused",
                        wrapper_stand_in)
    monkeypatch.setattr(tksvd, "_sweep_mode", mode)
    lt.reset_launch_counts()
    kw = {"exact": exact, "svd_iters": 3, "atom_block": atom_block}
    out, attrs = traced(X, D, G, **kw)
    n_power = 3 if exact else 1
    B = tksvd._block_size(D.shape[1], atom_block)
    assert asked == [(B, n_power)]
    if kernel:
        assert attrs == {"replayed": 0, "fused": 1} and modes == []
        assert lt.launch_counts()["ksvd_sweep"] == 1
        want = tksvd._sweep(X, D, G, 1, n_power)
    else:
        assert attrs == {"replayed": 0, "fused": 0}
        assert modes == [("gpu", B, n_power)]
        assert lt.launch_counts()["ksvd_sweep"] == 0
        want = tksvd._sweep(X, D, G, B, n_power)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_the_cpu_sweep_asks_no_kernel(monkeypatch):
    # on the CPU there is no graph key, so the kernel's predicate is not
    # asked and the dense sweep runs eager
    X, D, G = problem(6, "plain")
    monkeypatch.setattr(cuda_ksvd_sweep, "takes",
                        lambda *a: pytest.fail("takes asked on the CPU"))
    out, attrs = traced(X, D, G)
    assert attrs == {"replayed": 0, "fused": 0}
    assert all(torch.equal(a, b)
               for a, b in zip(out, tksvd._sweep(X, D, G, 1, 1)))


def test_the_learner_hands_each_sweep_to_the_kernel(monkeypatch):
    """Where ``takes`` holds, each iteration's sweep is one call of the
    kernel's wrapper: one counted launch an iteration.  The stand-in runs
    the plain version, the dense route's own sweep."""
    X, _, _ = problem(7, "plain", N=400)
    cfg = lt.KSVDConfig(K=24, T=3, n_iter=3)
    want = lt.KSVDLearner(cfg, device="cpu").fit(X).D_
    calls = []

    def wrapper_stand_in(X, D, Gamma, n_power):
        calls.append(n_power)
        _launch.count("ksvd_sweep")
        return tksvd._sweep(X, D, Gamma, 1, n_power)

    monkeypatch.setattr(tksvd, "_graph_key",
                        lambda X, D, B, n_power: ("gpu", B, n_power))
    monkeypatch.setattr(cuda_ksvd_sweep, "takes", lambda *a: True)
    monkeypatch.setattr(cuda_ksvd_sweep, "ksvd_sweep_fused",
                        wrapper_stand_in)
    lt.reset_launch_counts()
    got = lt.KSVDLearner(cfg, device="cpu").fit(X).D_
    assert calls == [1] * cfg.n_iter
    assert lt.launch_counts()["ksvd_sweep"] == cfg.n_iter
    assert float((got - want).abs().max()) <= 1e-3
    # the compact route keeps its own sweep
    calls.clear()
    lt.KSVDLearner(dataclasses.replace(cfg, codes="compact"),
                   device="cpu").fit(X)
    assert calls == []
