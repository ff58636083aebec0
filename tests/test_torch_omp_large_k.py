"""K1/K2 above the Gram form's shared-memory cap: the route choice of
``greedy.omp_route``, the residual-form kernel's wrapper
(``cuda_omp.omp_residual_fused``) and its envelope, and ``batch_omp``/``omp``
at a K above the cap against the reference's Pallas kernel in interpret
mode and the fp64 oracle (same float32 inputs from a numpy seed)."""

import contextlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lyssandra_tpu import oracle
from lyssandra_tpu.ops.pallas_omp import omp_fused as pallas_omp_fused
from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import (
    cuda_gram, cuda_omp, cuda_select, launch_counts, reset_launch_counts,
)
from lyssandra_tpu_torch.solvers import greedy
from tests.conftest import make_problem

torch.set_num_threads(1)

F32 = torch.float32

# (p, K, T) -> route on float32 CUDA tensors with float32 selection
_ROUTES = [
    ((64, 12304, 8), "gram"),        # the Gram form's largest K at p=64, T=8
    ((64, 12305, 8), "residual"),    # one atom past it
    ((64, 12256, 10), "gram"),       # SRC's T
    ((64, 12257, 10), "residual"),
    ((64, 16800, 10), "residual"),   # SRC on 16,800 training samples
    ((512, 10752, 32), "gram"),
    ((512, 10753, 32), "residual"),
    ((512, 65536, 32), "residual"),
    ((1, 1_000_000, 1), "residual"),
    ((513, 20000, 8), "plain"),      # p above the reference's gate
    ((768, 11553, 10), "plain"),
    ((768, 256, 10), "gram"),        # the Gram form has no cap on p
    ((64, 20000, 800), "plain"),     # a tile of lanes' state exceeds the
    #                                  chunk budget
    ((64, 20000, 723), "residual"),  # the largest T at p=64
    ((64, 20000, 724), "plain"),
    ((512, 20000, 1022), "residual"),  # 64-lane selection tiles above 256
    ((512, 20000, 1023), "plain"),
    ((512, 10753, 100), "residual"),
]


@pytest.mark.parametrize("shape, route", _ROUTES)
def test_route_at_its_boundaries(shape, route):
    assert greedy.omp_route("cuda", F32, F32, "f32", *shape) == route


@pytest.mark.parametrize("what", ["cpu", "bf16", "float64", "meta"])
def test_route_plain_off_the_kernels(what):
    kw = dict(device_type="cuda", D_dtype=F32, X_dtype=F32, corr_dtype="f32")
    kw.update({"cpu": {"device_type": "cpu"}, "bf16": {"corr_dtype": "bf16"},
               "float64": {"X_dtype": torch.float64},
               "meta": {"device_type": "meta"}}[what])
    for shape in ((64, 1024, 8), (64, 16384, 8)):
        assert greedy.omp_route(p=shape[0], K=shape[1], T=shape[2],
                                **kw) == "plain"


def test_route_of_tensors_and_fused_supported(monkeypatch):
    D = torch.empty((64, 16384))
    X = torch.empty((64, 4))
    assert greedy._route_of(D, X, 8) == "plain"        # CPU tensors
    assert not greedy._fused_supported(D, X, 8)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert greedy._route_of(D, X, 8) == "residual"
    assert greedy._fused_supported(D, X, 8)
    assert greedy._route_of(D[:, :1024], X, 8) == "gram"
    assert not greedy._fused_supported(D, X, 8, "bf16")
    assert not greedy._fused_supported(torch.empty((513, 16384)),
                                       torch.empty((513, 4)), 8)


# the envelope chip_smoke.py holds on the card: p up to 512, T up to 100
# (p=64) and 48 (p=512)
_ENVELOPE = [(p, T) for p in (1, 8, 21, 64, 256, 257, 512)
             for T in (1, 3, 8, 10, 32, 48, 100)]


@pytest.mark.parametrize("p, T, want", [
    (64, 8, 4 * (128 + 64 + 8 + 3)),
    (21, 3, 4 * (42 + 9 + 3 + 3)),
    (512, 32, 4 * (1024 + 1024 + 32 + 3)),
    (64, 100, 4 * (128 + 10000 + 100 + 3)),
])
def test_residual_lane_bytes(p, T, want):
    # x^T and r, Linv, a0, two list slots and the pick; nothing grows with K
    assert cuda_omp.residual_lane_bytes(p, T) == want


@pytest.mark.parametrize("p, T", _ENVELOPE)
def test_residual_chunk_lanes_over_the_envelope(p, T):
    rows = cuda_select.block_rows(p)
    lanes = cuda_omp.residual_chunk_lanes(p, T)
    per_lane = cuda_omp.residual_lane_bytes(p, T)
    # whole selection tiles, as many as the state budget holds
    assert lanes > 0 and lanes % rows == 0
    assert lanes * per_lane <= cuda_omp._STATE_BYTES
    assert (lanes + rows) * per_lane > cuda_omp._STATE_BYTES
    assert cuda_omp.residual_kernel_supports(p, 16384, T)
    assert cuda_omp.residual_step_smem_bytes(T) <= _build.SMEM_PER_BLOCK


def test_residual_chunk_lanes_at_the_main_shapes():
    # path (t) and SRC's predict are one chunk each; the envelope's widest
    # factors take a few
    assert cuda_omp.residual_chunk_lanes(64, 8) == 330496
    assert cuda_omp.residual_chunk_lanes(64, 10) >= 32768
    assert cuda_omp.residual_chunk_lanes(64, 100) == 6528
    assert cuda_omp.residual_chunk_lanes(512, 48) == 19840
    assert cuda_omp.residual_chunk_lanes(64, 724) == 0
    assert cuda_omp.residual_step_smem_bytes(8) == 4 * 8 * 5 * 8


@pytest.mark.parametrize("p, K, lanes, want", [
    (64, 16384, 32768, (5, 26)),     # path (t): 256 lane tiles
    (64, 16800, 7200, (19, 7)),      # SRC's predict on (n2): 57 tiles
    (64, 16384, 8192, (16, 8)),      # (s2)'s replicated omp
    (64, 16384, 256, (32, 4)),       # (t)'s grid: at least 4 atom tiles
    (512, 65536, 256, (128, 4)),     # 64-lane tiles above p=256
    (64, 1, 100, (1, 1)),
    (64, 1000, 10 ** 6, (1, 8)),     # lane tiles enough: no split
])
def test_residual_splits(p, K, lanes, want):
    assert cuda_omp.residual_splits(p, K, lanes, 132) == want


@pytest.mark.parametrize("p, K", [(1, 1), (64, 129), (64, 12305),
                                  (64, 16384), (512, 65536), (300, 1000003)])
@pytest.mark.parametrize("lanes", [1, 128, 7200, 32768, 330496])
def test_residual_splits_cover_the_atoms(p, K, lanes):
    # the ranges cover every atom tile once, none empty, each at least
    # _MIN_SPLIT_TILES tiles long or the whole of K
    nk = -(-K // 128)
    splits, tiles = cuda_omp.residual_splits(p, K, lanes, 132)
    assert (splits - 1) * tiles < nk <= splits * tiles
    assert tiles >= min(nk, cuda_omp._MIN_SPLIT_TILES)
    row_blocks = -(-lanes // cuda_select.block_rows(p))
    # split only while the lane tiles alone fill fewer blocks than wanted
    assert (splits - 1) * row_blocks < cuda_omp._SPLIT_BLOCKS * 132


def _stub_cuda(monkeypatch):
    """CUDA-looking meta tensors and a stand-in kernel library that records
    each call's name and arguments."""
    calls = []

    def record(name):
        return lambda *a: calls.append((name, a)) or 0

    lib = types.SimpleNamespace(
        lyssa_omp_residual_init=record("init"),
        lyssa_select_rows=record("select"),
        lyssa_omp_residual_step=record("step"),
        lyssa_omp_fused=record("gram"))

    def gram(A, B, *, symmetric=False):
        cuda_gram.gram.launches += 1
        return torch.empty((A.shape[1], B.shape[1]), device=A.device)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(cuda_omp._build, "load", lambda: lib)
    monkeypatch.setattr(cuda_omp, "gram", gram)
    monkeypatch.setattr(cuda_omp, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("eps_mode", [False, True])
def test_residual_wrapper_launches_once_without_gram(monkeypatch, eps_mode):
    # one chunk: one init launch, then a selection and a step launch a
    # step; no G, no Gram-form launch, and nothing read back to the host
    calls = _stub_cuda(monkeypatch)
    D = torch.empty((64, 16384), device="meta")
    X = torch.empty((64, 1000), device="meta")
    reset_launch_counts()
    idx, gamma, err, nsel = cuda_omp.omp_residual_fused(
        D, X, T=10, eps=2.0, eps_mode=eps_mode)
    counts = launch_counts()
    mode = "eps" if eps_mode else "t"
    assert counts[f"omp_residual_{mode}"] == 1
    assert counts["omp_residual_select"] == counts["omp_residual_update"] \
        == 10
    assert sum(counts.values()) == 21                  # no G, no K1/K2
    assert tuple(idx.shape) == (1000, 10) and tuple(nsel.shape) == (1000,)
    assert [c[0] for c in calls] == ["init"] + ["select", "step"] * 10
    # init: p, N, n0, lanes, eps^2, eps_mode
    assert calls[0][1][1:7] == (64, 1000, 0, 1000, 4.0, int(eps_mode))
    splits, tiles = cuda_omp.residual_splits(64, 16384, 1000, 132)
    for t in range(10):
        sel, step = calls[1 + 2 * t][1], calls[2 + 2 * t][1]
        # selection: p, K, the chunk's capacity, splits, tiles; its list
        # and count are the step's input
        assert sel[4:9] == (64, 16384, 1000, splits, tiles)
        assert (sel[1], sel[2]) == (step[8], step[9])
        # step: splits, p, capacity, T, t, eps^2, eps_mode; the last step
        # lists no lane
        assert step[7] == splits
        assert step[12:18] == (64, 1000, 10, t, 4.0, int(eps_mode))
        assert (step[10] is None) == (step[11] is None) == (t == 9)
        if t < 9:       # the next step reads the list this one writes
            nxt = calls[3 + 2 * t][1]
            assert (nxt[1], nxt[2]) == (step[10], step[11])
    with pytest.raises(ValueError, match="chunk of lanes"):
        cuda_omp.omp_residual_fused(D, X, T=800)
    with pytest.raises(ValueError, match="p <= 512"):
        cuda_omp.omp_residual_fused(torch.empty((513, 16384), device="meta"),
                                    torch.empty((513, 10), device="meta"),
                                    T=8)
    with pytest.raises(ValueError, match="float32"):
        cuda_omp.omp_residual_fused(D.double(), X, T=8)


def test_residual_wrapper_codes_in_chunks(monkeypatch):
    # T=100 at p=64 holds 6,528 lanes a chunk: 20,000 lanes are 4 chunks,
    # each with its own init at its first lane and zeroed counts
    calls = _stub_cuda(monkeypatch)
    D = torch.empty((64, 16384), device="meta")
    X = torch.empty((64, 20000), device="meta")
    reset_launch_counts()
    cuda_omp.omp_residual_fused(D, X, T=100)
    counts = launch_counts()
    assert counts["omp_residual_t"] == 4
    assert counts["omp_residual_select"] == \
        counts["omp_residual_update"] == 400
    inits = [a for name, a in calls if name == "init"]
    cap = cuda_omp.residual_chunk_lanes(64, 100)
    assert [(a[3], a[4]) for a in inits] == [
        (0, cap), (cap, cap), (2 * cap, cap), (3 * cap, 20000 - 3 * cap)]
    # each chunk's outputs start at its first lane: err and nsel at n0,
    # idx and gamma at n0 * T
    for a, n0 in zip(inits, (0, cap, 2 * cap, 3 * cap)):
        assert a[9] - inits[0][9] == 4 * n0
    steps = [a for name, a in calls if name == "step"]
    assert steps[100][18] - steps[0][18] == 4 * cap * 100
    # every step of every chunk sizes its grid by the capacity
    assert {a[13] for a in steps} == {cap}


@pytest.mark.parametrize("entry", ["batch_omp", "omp", "encoder", "src"])
def test_entry_points_take_the_route(monkeypatch, entry):
    # the route's kernel is the one launched: residual above the cap, the
    # Gram form (one G product) at and below it, for every caller
    from lyssandra_tpu_torch import SparseEncoder, SRCClassifier

    calls = _stub_cuda(monkeypatch)
    dev = torch.device("meta")
    for K, kind in ((12305, "residual"), (12304, "gram")):
        calls.clear()
        reset_launch_counts()
        D = torch.empty((64, K), device=dev)
        X = torch.empty((64, 48), device=dev)
        if entry == "batch_omp":
            greedy.batch_omp(D, X, 8, dense=False, device=dev)
        elif entry == "omp":
            greedy.omp(D, X, 8, eps=0.1, dense=False, device=dev)
        elif entry == "encoder":
            SparseEncoder("bomp", {"T": 8}, check_atoms=False,
                          device=dev).encode(X, D, dense=False)
        else:
            monkeypatch.setattr(greedy.GreedyResult, "dense",
                                lambda self, K: torch.zeros(
                                    (K, self.idx.shape[0]), device=dev))
            src = SRCClassifier(T=8, normalize=False, device=dev)
            src._set_dictionary(D, np.arange(K) % 3)
            src.residuals(X)
        want = (["gram"] if kind == "gram"
                else ["init"] + ["select", "step"] * 8)
        assert [c[0] for c in calls] == want, (K, calls)
        counts = launch_counts()
        assert counts["gram"] == (kind == "gram")
        mode = "eps" if entry == "omp" else "t"
        name = ("omp_residual_" if kind == "residual" else "omp_fused_") + mode
        assert counts[name] == 1


def test_residual_wrapper_runs_plain_version_on_cpu(rng):
    D, X, _ = make_problem(rng, p=12, K=300, N=50, T=3)
    Dt, Xt = (torch.from_numpy(a.astype(np.float32)) for a in (D, X))
    reset_launch_counts()
    got = cuda_omp.omp_residual_fused(Dt, Xt, T=4)
    want = cuda_omp.omp_fused_reference(Dt, Xt, T=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert sum(launch_counts().values()) == 0


# K above the Gram form's cap at p=64, T=8 (12,304), a multiple of 128 so
# that the Pallas kernel takes it unpadded
_P, _K, _T, _N = 64, 12416, 8, 256


def _planted(eps_mode):
    rng = np.random.default_rng(7)
    D, X, _ = make_problem(rng, p=_P, K=_K, N=_N, T=_T if not eps_mode else 4)
    if eps_mode:
        X[:, ::2] *= 0.05
    return D.astype(np.float32), X.astype(np.float32)


def _hold(got, want, exact=True):
    """got against want, lane by lane: idx (up to nsel) and nsel equal on
    every lane; where they are, |dgamma| <= 1e-4 and err within rtol
    1e-4."""
    idx, gamma, err, nsel = (np.asarray(a) for a in got)
    widx, wgamma, werr, wnsel = (np.asarray(a) for a in want)
    keep = np.arange(idx.shape[1])[None, :] < wnsel[:, None]
    same = (nsel == wnsel) & ((idx == widx) | ~keep).all(axis=1)
    assert same.all(), np.where(~same)[0]
    np.testing.assert_allclose(gamma, wgamma, rtol=0, atol=1e-4)
    np.testing.assert_allclose(err, werr, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("eps_mode", [False, True])
@pytest.mark.parametrize("entry", ["batch_omp", "omp"])
def test_above_the_cap_matches_pallas_interpret(eps_mode, entry):
    D, X = _planted(eps_mode)
    eps = 0.05 if eps_mode else None
    got = getattr(greedy, entry)(torch.from_numpy(D), torch.from_numpy(X),
                                 _T, eps, dense=False)
    want = pallas_omp_fused(jnp.asarray(D), jnp.asarray(X), T=_T,
                            eps=eps or 0.0, eps_mode=eps_mode, block=_N,
                            interpret=True)
    _hold(got, want)
    # the kernel's plain version is the same solve
    ref = cuda_omp.omp_residual_fused(torch.from_numpy(D),
                                      torch.from_numpy(X), T=_T,
                                      eps=eps or 0.0, eps_mode=eps_mode)
    _hold(got, ref)
    if eps_mode:
        assert np.asarray(got[3]).mean() < _T


@pytest.mark.parametrize("eps_mode", [False, True])
def test_above_the_cap_matches_oracle(eps_mode):
    D, X = _planted(eps_mode)
    eps = 0.05 if eps_mode else None
    got = greedy.batch_omp(D, X, _T, eps, device="cpu").numpy()
    want = oracle.batch_omp(D.astype(np.float64), X.astype(np.float64), _T,
                            eps)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
