"""K-SVD's sweep kernel (``ops/cuda_ksvd_sweep.py``, csrc/ksvd_sweep.cu) on
the card: against the dense sweep in float64 and against its plain version,
the dense sweep in float32, at config 2's shape (p=64, K=512, N=50,000, T=8 codes from K1) and at the
adaptive denoiser's (K=256, N=30,000), within the ksvd-c2 check's atom
limits (1e-4 largest, 1e-6 median distance); at odd shapes (p of each
register width, N not a multiple of the cluster, CTAs that own no lanes,
atoms without users, an atom every lane uses, duplicate atoms, three power
steps); bit for bit equal over two launches, its inputs unchanged; its
shared memory as the wrapper computes it; one launch
on the ``ksvd_sweep`` counter a sweep through ``ksvd_atom_update``, which
keeps its graph path inside a caller's capture.  Skipped without a CUDA
GPU.  Imports no JAX, so that the card can run it without this directory's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ksvd_sweep_card.py
"""

import importlib

import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import cuda_ksvd_sweep
from lyssandra_tpu_torch.ops.cuda_ksvd_sweep import ksvd_sweep_fused
from lyssandra_tpu_torch.utils import clear_spans, spans

tksvd = importlib.import_module("lyssandra_tpu_torch.dict_learning.ksvd")

ATOM_MAX, ATOM_MEDIAN = 1e-4, 1e-6     # the ksvd-c2 check's atom limits


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card)")
    return torch.device("cuda", 0)


def coded(seed, dev, p, K, N, T=8):
    """X (p, N) of unit-scale signals, each a noisy mix of 4 atoms of
    another dictionary; D (p, K) of X's own columns, as the 'data' start
    draws them; Gamma (K, N) the fixed-T codes of X over D from K1."""
    g = torch.Generator(dev).manual_seed(seed)
    Dt = torch.randn(p, 2 * K, generator=g, device=dev)
    Dt /= torch.linalg.vector_norm(Dt, dim=0, keepdim=True)
    idx = torch.rand(2 * K, N, generator=g, device=dev).topk(4, dim=0).indices
    G = torch.zeros(2 * K, N, device=dev).scatter_(
        0, idx, torch.randn(4, N, generator=g, device=dev))
    X = Dt @ G + 0.05 * torch.randn(p, N, generator=g, device=dev)
    D = X[:, torch.randperm(N, generator=g, device=dev)[:K]]
    D = D / torch.linalg.vector_norm(D, dim=0, keepdim=True)
    Gamma = lt.batch_omp(D, X, T)
    return X, D, Gamma


def atom_gaps(got, want):
    return torch.linalg.vector_norm(got.double() - want.double(), dim=0)


def held(gaps):
    return (float(gaps.max()) <= ATOM_MAX
            and float(gaps.median()) <= ATOM_MEDIAN)


@pytest.mark.card
@pytest.mark.parametrize("K,N,n_power", [
    (512, 50_000, 1),        # config 2
    (256, 30_000, 1),        # the adaptive denoiser's training
    (256, 30_000, 3),        # exact=True, svd_iters=3
], ids=["config2", "adaptive", "adaptive-exact3"])
def test_kernel_holds_the_float64_sweep_at_the_main_shapes(card, K, N,
                                                           n_power):
    X, D, Gamma = coded(K + N, card, 64, K, N)
    assert int((Gamma != 0).sum(dim=0).max()) <= 8
    got = ksvd_sweep_fused(X, D, Gamma, n_power)
    want = tksvd._sweep(X.double(), D.double(), Gamma.double(), 1, n_power)
    plain = tksvd._sweep(X, D, Gamma, 1, n_power)
    gaps = atom_gaps(got[0], want[0])
    assert held(gaps), (float(gaps.max()), float(gaps.median()))
    assert held(atom_gaps(plain[0], want[0]))
    assert held(atom_gaps(got[0], plain[0]))
    # the codes keep their supports; their values within 1e-4 of the
    # largest of their column
    assert torch.equal(got[1] != 0, Gamma != 0)
    scale = want[1].abs().amax(dim=0).clamp_min(1e-12)
    assert float(((got[1].double() - want[1]).abs() / scale).max()) <= 1e-4


def planted(dev, p, K, N, T=3, seed=0):
    """Codes with T random atoms a lane, atom 1 unused, atom 2 used by every
    lane and atom 4 a copy of atom 3; X = D Gamma plus noise."""
    g = torch.Generator(dev).manual_seed(seed)
    D = torch.randn(p, K, generator=g, device=dev)
    D[:, 4] = D[:, 3]
    D /= torch.linalg.vector_norm(D, dim=0, keepdim=True)
    idx = torch.rand(K, N, generator=g, device=dev).topk(T, dim=0).indices
    Gamma = torch.zeros(K, N, device=dev).scatter_(
        0, idx, torch.randn(T, N, generator=g, device=dev))
    Gamma[1] = 0.0
    Gamma[2] = torch.randn(N, generator=g, device=dev)
    X = D @ Gamma + 0.05 * torch.randn(p, N, generator=g, device=dev)
    return X, D, Gamma


@pytest.mark.card
@pytest.mark.parametrize("p,K,N,n_power", [
    (64, 40, 1001, 1),      # N not a multiple of 4 or of the cluster
    (7, 30, 333, 3),        # p under a warp
    (100, 50, 4096, 1),     # four floats a lane
    (256, 20, 2000, 2),     # the widest p
    (33, 16, 70_000, 1),    # lanes past 4,096 a CTA
    (64, 50, 130, 1),       # a class of LC-KSVD's init: 9 lanes a CTA
    (5, 8, 10, 2),          # fewer lanes than CTAs: most own none
])
def test_kernel_holds_the_float64_sweep_at_odd_shapes(card, p, K, N,
                                                      n_power):
    X, D, Gamma = planted(card, p, K, N)
    got = ksvd_sweep_fused(X, D, Gamma, n_power)
    want = tksvd._sweep(X.double(), D.double(), Gamma.double(), 1, n_power)
    gaps = atom_gaps(got[0], want[0])
    assert held(gaps), (float(gaps.max()), float(gaps.median()))
    assert torch.equal(got[0][:, 1], D[:, 1])           # no users: kept
    assert torch.equal(got[1][1], Gamma[1])
    assert torch.equal(got[1] != 0, Gamma != 0)
    scale = want[1].abs().amax(dim=0).clamp_min(1e-12)
    assert float(((got[1].double() - want[1]).abs() / scale).max()) <= 1e-4


@pytest.mark.card
def test_two_launches_agree_bit_for_bit_and_leave_the_inputs(card):
    X, D, Gamma = coded(7, card, 64, 512, 50_000)
    Gamma[:, :5] = -0.0 * Gamma[:, :5].abs()    # signed zeros pass through
    before = [t.clone() for t in (X, D, Gamma)]
    one = ksvd_sweep_fused(X, D, Gamma, 1)
    two = ksvd_sweep_fused(X, D, Gamma, 1)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert torch.equal(one[1][:, :5].signbit(), Gamma[:, :5].signbit())
    for t, t0 in zip((X, D, Gamma), before):
        assert torch.equal(t, t0)


@pytest.mark.card
def test_shared_memory_is_the_wrappers_formula(card):
    lib = _build.load()
    for p, N in ((64, 50_000), (7, 333), (256, 2000), (64, 30_000),
                 (5, 10)):
        assert lib.lyssa_ksvd_sweep_smem_bytes(p, N) == \
            cuda_ksvd_sweep.smem_bytes(p, N)


def swept(x, **kw):
    """``ksvd_atom_update(*x, **kw)`` under a profiler, and its sweep
    span's attributes."""
    clear_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out = tksvd.ksvd_atom_update(*x, **kw)
        recs = [r for r in spans() if r.name == "lyssa.ksvd.sweep"]
    finally:
        clear_spans()
    torch.cuda.synchronize()
    assert len(recs) == 1
    return out, recs[0].attrs


@pytest.mark.card
def test_one_launch_a_sweep_through_ksvd_atom_update(card):
    x = coded(9, card, 64, 256, 30_000)
    lt.reset_launch_counts()
    got, attrs = swept(x)
    assert attrs == {"replayed": 0, "fused": 1}
    counts = lt.launch_counts()
    assert counts["ksvd_sweep"] == 1 and sum(counts.values()) == 1
    assert all(torch.equal(a, b)
               for a, b in zip(got, ksvd_sweep_fused(*x, 1)))
    got3, attrs = swept(x, exact=True, svd_iters=3)
    assert attrs["fused"] == 1
    assert all(torch.equal(a, b)
               for a, b in zip(got3, ksvd_sweep_fused(*x, 3)))
    # atom blocks of 8 keep the dense sweep
    lt.reset_launch_counts()
    _, attrs = swept(x, atom_block=8)
    assert attrs["fused"] == 0 and lt.launch_counts()["ksvd_sweep"] == 0


@pytest.mark.card
def test_a_callers_capture_keeps_the_dense_sweep(card):
    x = coded(10, card, 64, 256, 4096)
    want = tksvd._sweep(*x, 1, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tksvd._sweep(*x, 1, 1)
    torch.cuda.current_stream().wait_stream(side)
    lt.reset_launch_counts()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        out = tksvd.ksvd_atom_update(*x)
    outer.replay()
    torch.cuda.synchronize()
    assert lt.launch_counts()["ksvd_sweep"] == 0
    assert all(torch.equal(a, b) for a, b in zip(out, want))
