"""The feature-sign search kernel's route on the CPU: the envelope that
``solvers.lasso._fs_scan_supported`` and ``ops.cuda_fs_scan.kernel_supports``
decide before launch, ``feature_sign_scan`` on CPU tensors (the plain loop,
its codes and host reads unchanged), the route's hand-off to the kernel's
wrapper (through a stand-in: the kernel itself runs only on the card, in
``tests/test_torch_fs_scan_card.py``) and the launch counter."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.ops import cuda_fs_scan
from lyssandra_tpu_torch.ops.cuda_fs_scan import (
    fs_scan_fused,
    fs_scan_fused_reference,
    kernel_supports,
    lane_smem_bytes,
)
from lyssandra_tpu_torch.solvers.lasso import (
    _fs_init,
    _fs_loop,
    _fs_scan_supported,
    host_syncs,
)
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
    assert fs_scan_fused.launches == 0


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
    fs_scan_fused.launches = 3
    try:
        assert lt.launch_counts()["fs_scan"] == 3
    finally:
        lt.reset_launch_counts()
    assert fs_scan_fused.launches == 0
    assert lt.launch_counts()["fs_scan"] == 0
