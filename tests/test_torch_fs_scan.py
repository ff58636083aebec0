"""The feature-sign search kernel's route on the CPU: the envelope that
``solvers.lasso._fs_scan_supported`` and ``ops.cuda_fs_scan.kernel_supports``
decide before launch, ``feature_sign_scan`` on CPU tensors (the plain loop,
its codes and host reads unchanged), the route's hand-off to the kernel's
wrapper (through a stand-in: the kernel itself runs only on the card, in
``tests/test_torch_fs_scan_card.py``) and the launch counter.  The same for
the seeded entry, which runs ``feature_sign``'s loop after its cold start:
its plain version against ``_fs_loop`` from the same handoff, the gate
``_fs_seeded_supported``, the option sets that take it, its one host read
and the ``fused`` attribute of the span ``lyssa.fs.loop``."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.ops import _launch, cuda_fs_scan
from lyssandra_tpu_torch.ops.cuda_fs import fs_cold_fused_reference
from lyssandra_tpu_torch.ops.cuda_fs_scan import (
    fs_scan_fused,
    fs_scan_fused_reference,
    fs_scan_seeded,
    fs_scan_seeded_reference,
    kernel_supports,
    lane_smem_bytes,
)
from lyssandra_tpu_torch.solvers.lasso import (
    _fs_init,
    _fs_loop,
    _fs_scan_supported,
    _fs_seeded_supported,
    _pad_handoff,
    host_syncs,
)
from lyssandra_tpu_torch.utils import clear_spans, spans
from tests.conftest import make_problem

tl = importlib.import_module("lyssandra_tpu_torch.solvers.lasso")
tonline = importlib.import_module("lyssandra_tpu_torch.dict_learning.online")

LAM = 0.15
# the online fit's call at config 4 (fs_max_active 64, fs_warm_start 0,
# fs_cold_unroll 0, one activation an iteration)
CALL = dict(max_active=64, n_activate=1, warm_start=0, cold_unroll=0)
# the largest K whose lane state fits a block's shared memory
K_CAP = 51867


def _on_card(p, K, dtype=torch.float32):
    """What the gate reads of a CUDA tensor (p, K), without a card."""
    return SimpleNamespace(is_cuda=True, dtype=dtype, shape=(p, K))


def _problem(rng, N=48):
    D, X, _ = make_problem(rng, p=16, K=24, N=N, T=3)
    return (torch.from_numpy(D.astype(np.float32)),
            torch.from_numpy(X.astype(np.float32)))


def test_the_kernel_takes_config_4s_call():
    assert _fs_scan_supported(_on_card(192, 1024), _on_card(192, 4096),
                              **CALL)


@pytest.mark.parametrize("change", [
    {"max_active": 65}, {"n_activate": 2}, {"warm_start": 4},
    {"cold_unroll": 28}, {"K": K_CAP + 1}, {"cpu": True},
    {"dtype": torch.float64},
], ids=["max_active-65", "n_activate-2", "warm_start-4", "cold_unroll-28",
        "K-over-the-cap", "cpu-tensors", "float64"])
def test_the_kernel_refuses_outside_its_envelope(change):
    change = dict(change)
    K = change.pop("K", 1024)
    dtype = change.pop("dtype", torch.float32)
    if change.pop("cpu", False):
        D, X = torch.ones(192, K), torch.ones(192, 8)
    else:
        D, X = _on_card(192, K, dtype), _on_card(192, 8, dtype)
    assert not _fs_scan_supported(D, X, **dict(CALL, **change))


def test_kernel_envelope_and_shared_memory():
    # compact Gram (64, 65), 7 x 64 slot words, 16 exchange words, a bit
    # per atom and the alpha0 row: 22,720 bytes a lane at K=1024
    assert lane_smem_bytes(1024) == 22720
    assert kernel_supports(192, 1024, 64)
    assert kernel_supports(192, K_CAP, 64)
    assert not kernel_supports(192, K_CAP + 1, 64)
    assert kernel_supports(3, 5, 1)
    assert not kernel_supports(192, 1024, 0)
    assert not kernel_supports(0, 1024, 64)


def test_the_wrapper_on_cpu_is_the_plain_loop(rng):
    D, X = _problem(rng)
    G, done, ovf, A0 = fs_scan_fused(D, X, lam=LAM, max_iter=5)
    A0p = X.T @ D
    _, res, _ = _fs_loop(D.T, X.T, A0p, LAM, _fs_init(A0p, LAM, 64),
                         max_active=64, max_iter=5, max_inner=6)
    assert torch.equal(G, res.Gamma) and torch.equal(done, res.done)
    assert torch.equal(ovf, res.overflow) and torch.equal(A0, A0p)
    assert lt.launch_counts()["fs_scan"] == 0


def test_the_wrapper_refuses_a_device_without_a_kernel():
    D = torch.ones(16, 24, device="meta")
    X = torch.ones(16, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fs_scan_fused(D, X, lam=LAM)


@pytest.mark.parametrize("kw", [{}, {"max_iter": 2}, {"max_active": 2}],
                         ids=["done", "cut", "overflow"])
def test_cpu_scan_keeps_the_plain_loop_and_its_host_reads(rng, kw):
    # CPU tensors never take the kernel: the codes are the plain loop's
    # (then the polish of lanes not done or overflowed), and the host reads
    # are the loop's exits and the polish gate
    D, X = _problem(rng)
    s0 = host_syncs()
    G = lt.feature_sign_scan(D, X, LAM, **kw)
    reads = host_syncs() - s0
    s0 = host_syncs()
    Gp, done, ovf, A0 = fs_scan_fused_reference(D, X, lam=LAM, **kw)
    loop_reads = host_syncs() - s0
    assert reads == loop_reads + 1
    assert loop_reads > 1
    want = tl._fs_scan_polish(D, X, LAM, A0, Gp, ~done | ovf)
    assert torch.equal(G, want)
    if not kw:
        assert bool(done.all()) and torch.equal(G, Gp)


def test_the_route_hands_the_call_to_the_kernel(rng, monkeypatch):
    # with the gate open, feature_sign_scan calls the wrapper once and reads
    # one flag on the host (the polish gate); the wrapper's alpha0 feeds the
    # polish
    D, X = _problem(rng)
    out = fs_scan_fused_reference(D, X, lam=LAM, max_iter=2)
    calls = []

    def stand_in(D_, X_, **kw):
        calls.append(kw)
        return out

    monkeypatch.setattr(tl, "_fs_scan_supported", lambda *a, **k: True)
    monkeypatch.setattr(cuda_fs_scan, "fs_scan_fused", stand_in)
    s0 = host_syncs()
    G = lt.feature_sign_scan(D, X, LAM, max_iter=2)
    assert host_syncs() - s0 == 1
    assert calls == [dict(lam=LAM, max_active=64, max_iter=2, max_inner=6,
                          max_cg=32)]
    Gp, done, ovf, A0 = out
    assert torch.equal(G, tl._fs_scan_polish(D, X, LAM, A0, Gp,
                                             ~done | ovf))


def test_code_blocks_call_the_kernel_once_a_block(rng, monkeypatch):
    D, X = _problem(rng, N=64)
    calls = []

    def stand_in(D_, X_, **kw):
        calls.append(X_.shape[1])
        return fs_scan_fused_reference(D_, X_, **kw)

    monkeypatch.setattr(tl, "_fs_scan_supported", lambda *a, **k: True)
    monkeypatch.setattr(cuda_fs_scan, "fs_scan_fused", stand_in)
    opts = dict(max_active=64, max_iter=60, max_inner=6, warm_start=0,
                cold_unroll=0)
    G = tonline._code_batch(D, X, LAM, "feature_sign", opts, code_blocks=4)
    assert calls == [16, 16, 16, 16]
    assert G.shape == (24, 64)


def test_launch_counts_list_and_reset_fs_scan():
    lt.reset_launch_counts()
    assert lt.launch_counts()["fs_scan"] == 0
    for _ in range(3):
        _launch.count("fs_scan")
    try:
        assert lt.launch_counts()["fs_scan"] == 3
    finally:
        lt.reset_launch_counts()
    assert lt.launch_counts()["fs_scan"] == 0


# feature_sign's call at the lasso cell's settings (max_active 64, max_iter
# 100, max_inner 6, max_cg 32, one activation an iteration)
SEEDED_CALL = dict(max_active=64, n_activate=1, max_iter=100, max_inner=6,
                   max_cg=32)
TUN = 3


@pytest.mark.parametrize("slots", [64, 16], ids=["full", "auto-capacity"])
def test_the_seeded_entry_takes_feature_signs_call(slots):
    assert _fs_seeded_supported(_on_card(192, 1024), _on_card(192, 2048),
                                **dict(SEEDED_CALL, max_active=slots))


@pytest.mark.parametrize("change", [
    {"n_activate": 2}, {"max_active": 65}, {"max_cg": -1},
    {"K": K_CAP + 1}, {"cpu": True}, {"dtype": torch.float64},
], ids=["n_activate-2", "max_active-65", "max_cg-negative", "K-over-the-cap",
        "cpu-tensors", "float64"])
def test_the_seeded_entry_refuses_outside_its_envelope(change):
    change = dict(change)
    K = change.pop("K", 1024)
    dtype = change.pop("dtype", torch.float32)
    if change.pop("cpu", False):
        D, X = torch.ones(192, K), torch.ones(192, 8)
    else:
        D, X = _on_card(192, K, dtype), _on_card(192, 8, dtype)
    assert not _fs_seeded_supported(D, X, **dict(SEEDED_CALL, **change))


@pytest.mark.parametrize("kw", [{}, {"max_iter": 2}, {"max_active": 4}],
                         ids=["done", "cut", "overflow"])
def test_seeded_plain_version_is_the_loop_from_the_handoff(rng, kw):
    # the wrapper on CPU tensors from the cold start's handoff (its plain
    # version) against one _fs_loop call from the same state, padded
    D, X = _problem(rng)
    A, n_it = kw.get("max_active", 64), kw.get("max_iter", 100)
    seed = fs_cold_fused_reference(D, X, lam=LAM, t_unroll=TUN)
    lt.reset_launch_counts()
    G, done, ovf, iters = fs_scan_seeded(D, X, seed, lam=LAM, max_active=A,
                                         max_iter=n_it)
    A0 = X.T @ D
    _, res, _ = _fs_loop(D.T, X.T, A0, LAM,
                         _pad_handoff(*seed, max_active=A), max_active=A,
                         max_iter=n_it, max_inner=6)
    assert torch.equal(G, res.Gamma) and torch.equal(done, res.done)
    assert torch.equal(ovf, res.overflow)
    # each lane's count: none for a lane done on entry, the largest is the
    # loop's own count after the seed's TUN steps
    assert iters.dtype == torch.int32 and int(iters.max()) <= n_it
    assert not bool(iters[seed[5]].any()) and bool(seed[5].any())
    assert TUN + int(iters.max()) == res.n_iter
    assert bool(ovf.any()) == ("max_active" in kw)
    assert bool(done.all()) == ("max_iter" not in kw)
    assert lt.launch_counts()["fs_scan_seeded"] == 0


def test_the_seeded_wrapper_refuses_a_device_without_a_kernel():
    D = torch.ones(16, 24, device="meta")
    X = torch.ones(16, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fs_scan_seeded(D, X, (None,) * 6, lam=LAM)


def _auto_problem():
    # p = 32, K = 48, lam 0.2: 15 of the 40 lanes want more than 16 atoms,
    # so auto_capacity's 16-slot run overflows and re-solves them
    rng = np.random.default_rng(1)
    D = rng.standard_normal((32, 48)).astype(np.float32)
    X = rng.standard_normal((32, 40)).astype(np.float32)
    return (torch.from_numpy(D / np.linalg.norm(D, axis=0)),
            torch.from_numpy(X / np.linalg.norm(X, axis=0)))


# option sets of feature_sign, each with the seeded calls it makes: (the
# seed's slots, the slots it runs at) a call
ROUTED = {
    "k6-handoff": ({"cold_unroll": TUN, "cold_backend": "pallas"},
                   [(TUN, 64)]),
    "k6-cut": ({"cold_unroll": TUN, "cold_backend": "pallas",
                "max_iter": 2}, [(TUN, 64)]),
    "k6-stragglers": ({"cold_unroll": TUN, "cold_backend": "pallas",
                       "compact_stragglers": True}, [(TUN, 64)]),
    "k6-overflow": ({"cold_unroll": TUN, "cold_backend": "pallas",
                     "max_active": 4}, [(TUN, 4)]),
    "plain-cold-start": ({"cold_unroll": TUN, "cold_backend": "xla"},
                         [(64, 64)]),
    "warm-omp": ({"warm_start": 4}, [(64, 64)]),
    "empty-start": ({"warm_start": 0}, [(64, 64)]),
    "no-polish": ({"cold_unroll": TUN, "cold_backend": "pallas",
                   "polish": False}, [(TUN, 64)]),
    "auto-capacity": ({"warm_start": 0, "auto_capacity": True},
                      [(16, 16), (64, 64)]),
}


def _routed(monkeypatch):
    """Open the seeded entry's gate on CPU tensors; the wrapper's stand-in
    records each call's (seed slots, max_active) and runs the plain
    version, whose own host reads it keeps apart."""
    calls, own = [], []

    def stand_in(D_, X_, seed, **kw):
        calls.append((seed[0].shape[1], kw["max_active"]))
        kw.pop("products")              # the plain version makes its own
        s0 = host_syncs()
        out = fs_scan_seeded_reference(D_, X_, seed, **kw)
        own.append(host_syncs() - s0)
        return out

    monkeypatch.setattr(tl, "_fs_seeded_supported", lambda *a, **k: True)
    monkeypatch.setattr(cuda_fs_scan, "fs_scan_seeded", stand_in)
    return calls, own


@pytest.mark.parametrize("case", sorted(ROUTED))
def test_feature_sign_routes_its_loop_to_the_seeded_entry(rng, monkeypatch,
                                                          case):
    # codes, n_iter, done and overflow are the plain loop's, bit for bit
    opts, want_calls = ROUTED[case]
    D, X = _auto_problem() if case == "auto-capacity" else _problem(rng)
    lam = 0.2 if case == "auto-capacity" else LAM
    want = tl.feature_sign(D, X, lam, full_result=True, **opts)
    calls, _ = _routed(monkeypatch)
    got = tl.feature_sign(D, X, lam, full_result=True, **opts)
    assert calls == want_calls
    assert torch.equal(got.Gamma, want.Gamma)
    assert got.n_iter == want.n_iter
    assert torch.equal(got.done, want.done)
    assert torch.equal(got.overflow, want.overflow)


@pytest.mark.parametrize("opts", [{"n_activate": 2}, {}],
                         ids=["n_activate-2", "cpu-tensors"])
def test_feature_sign_keeps_the_plain_loop(rng, monkeypatch, opts):
    # CPU tensors, or two activations an iteration: the segmented loop
    D, X = _problem(rng)
    seeded, segmented = [], []
    monkeypatch.setattr(cuda_fs_scan, "fs_scan_seeded",
                        lambda *a, **k: seeded.append(1))
    run = tl._fs_segments

    def counted(*a, **kw):
        segmented.append(1)
        return run(*a, **kw)

    monkeypatch.setattr(tl, "_fs_segments", counted)
    if opts:
        # the gate as on a card: only n_activate closes it
        real = tl._fs_seeded_supported
        monkeypatch.setattr(
            tl, "_fs_seeded_supported",
            lambda D_, X_, **kw: real(_on_card(*D_.shape), _on_card(
                *X_.shape), **kw))
    tl.feature_sign(D, X, LAM, cold_unroll=TUN, cold_backend="pallas",
                    **opts)
    assert seeded == [] and segmented == [1]


@pytest.mark.parametrize("polish", [True, False], ids=["polish", "no-polish"])
def test_the_seeded_route_reads_the_host_once(rng, monkeypatch, polish):
    # after K6's handoff the route's only read is the polish gate (or, with
    # no polish, n_iter's); the plain loop reads at every exit
    D, X = _problem(rng)
    opts = dict(cold_unroll=TUN, cold_backend="pallas", polish=polish)
    s0 = host_syncs()
    tl.feature_sign(D, X, LAM, **opts)
    plain = host_syncs() - s0
    _, own = _routed(monkeypatch)
    s0 = host_syncs()
    tl.feature_sign(D, X, LAM, **opts)
    assert host_syncs() - s0 - sum(own) == 1
    assert plain > 5


@pytest.mark.parametrize("routed", [False, True], ids=["cpu", "seeded"])
def test_loop_span_says_whether_the_kernel_ran_it(rng, monkeypatch, routed):
    D, X = _problem(rng)
    opts = dict(cold_unroll=TUN, cold_backend="pallas")
    if routed:
        seed = fs_cold_fused_reference(D, X, lam=LAM, t_unroll=TUN)
        out = fs_scan_seeded_reference(D, X, seed, lam=LAM)
        monkeypatch.setattr(tl, "_fs_seeded_supported",
                            lambda *a, **k: True)
        monkeypatch.setattr(cuda_fs_scan, "fs_scan_seeded",
                            lambda *a, **k: out)
    clear_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            tl.feature_sign(D, X, LAM, **opts)
        loops = [r for r in spans() if r.name == "lyssa.fs.loop"]
    finally:
        clear_spans()
    (loop,) = loops
    assert loop.attrs["fused"] == int(routed)
    assert loop.attrs["segments"] >= 1
    assert (loop.attrs["syncs"] == 0) == routed


def test_launch_counts_list_and_reset_fs_scan_seeded():
    lt.reset_launch_counts()
    _launch.count("fs_scan_seeded")
    try:
        assert lt.launch_counts()["fs_scan_seeded"] == 1
        assert lt.launch_counts()["fs_scan"] == 0
    finally:
        lt.reset_launch_counts()
    assert lt.launch_counts()["fs_scan_seeded"] == 0
