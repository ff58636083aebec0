"""The online sweep's route on the CPU: ``online_sweep_reference`` is the
learner's former loop bit for bit (dead atoms, two sweeps, atoms whose norm
stays under 1); ``_dict_update_body`` runs it on CPU tensors; the kernel's
envelope (``takes``, ``cluster_size``, ``smem_bytes``) accepts and refuses
as it should; and the learner hands the sweep to the kernel's wrapper once
a minibatch where ``takes`` holds (through a stand-in: the kernel itself
runs only on the card, in ``tests/test_torch_online_sweep_card.py``)."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import cuda_online_sweep
from lyssandra_tpu_torch.ops.cuda_online_sweep import (
    cluster_size,
    online_sweep_fused,
    online_sweep_reference,
    smem_bytes,
    takes,
)

tonline = importlib.import_module("lyssandra_tpu_torch.dict_learning.online")


def former_loop(D, A, B, n_sweeps):
    """The learner's sweep as it was written before the kernel."""
    D = D.clone()
    K = D.shape[1]
    akk = torch.diagonal(A)
    dead = akk < 1e-10
    akk = akk.clamp_min(1e-10)
    for _ in range(n_sweeps):
        for k in range(K):
            dk = D[:, k]
            u = dk + torch.addmv(B[:, k], D, A[:, k], alpha=-1.0) / akk[k]
            u = u / torch.linalg.vector_norm(u).clamp_min(1.0)
            D[:, k] = torch.where(dead[k], dk, u)
    return D


def statistics(seed, p=12, K=24, n=64, dead=0, scale=1.0,
               dtype=torch.float32):
    """D (p, K) with unit atoms and A = G G^T, B = X G^T of n signals that
    use all but ``dead`` atoms; ``scale`` multiplies B."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    G = rng.standard_normal((K, n)) * (rng.random((K, n)) < 0.3)
    G[rng.permutation(K)[:dead]] = 0.0
    X = rng.standard_normal((p, n))
    return [torch.as_tensor(v, dtype=dtype)
            for v in (D, G @ G.T, scale * (X @ G.T))]


@pytest.mark.parametrize("dead,n_sweeps,scale", [
    (0, 1, 1.0), (5, 1, 1.0), (3, 2, 1.0), (0, 2, 1e-3), (24, 1, 1.0),
    (2, 0, 1.0),
], ids=["plain", "dead", "two-sweeps", "short-atoms", "all-dead",
        "no-sweep"])
def test_reference_is_the_former_loop_bit_for_bit(dead, n_sweeps, scale):
    D, A, B = statistics(dead * 10 + n_sweeps, dead=dead, scale=scale)
    before = [t.clone() for t in (D, A, B)]
    got = online_sweep_reference(D, A, B, n_sweeps)
    assert torch.equal(got, former_loop(D, A, B, n_sweeps))
    for t, t0 in zip((D, A, B), before):
        assert torch.equal(t, t0)
    dead_k = torch.diagonal(A) < 1e-10
    assert torch.equal(got[:, dead_k], D[:, dead_k])
    norms = torch.linalg.vector_norm(got, dim=0)
    if scale < 1 and n_sweeps:
        # B scaled down: some updated atoms come out shorter than 1, and
        # the projection leaves them so
        assert bool((norms[~dead_k] < 1 - 1e-3).any())
    assert float(norms.max()) <= 1 + 1e-6


def test_the_learners_sweep_on_the_cpu_is_the_former_loop():
    D, A, B = statistics(7, dead=2)
    assert not takes(D, A, B, 2)
    lt.reset_launch_counts()
    assert torch.equal(tonline._dict_update_body(D, A, B, 2),
                       former_loop(D, A, B, 2))
    assert torch.equal(online_sweep_fused(D, A, B, 2),
                       former_loop(D, A, B, 2))
    assert lt.launch_counts()["online_sweep"] == 0


def _card(*shape, dtype=torch.float32, device="cuda:0"):
    """What ``takes`` reads of a CUDA tensor, without a card."""
    return SimpleNamespace(is_cuda=True, dtype=dtype, shape=shape,
                           device=torch.device(device))


def _cpu(*shape):
    return torch.zeros(shape)


def test_smem_bytes_match_the_kernels_layout():
    # the sizes csrc/online_sweep.cu's lyssa_online_sweep_smem_bytes gave on
    # the card at config 4 (p=192, K=1024)
    assert [smem_bytes(192, 1024, c) for c in (4, 8, 16)] == [
        205440, 107200, 58464]
    # rows of D at a row stride of K padded to 4, two column and B buffers,
    # two slots of one partial a warp (one warp a row up to 8) a CTA
    assert smem_bytes(7, 97, 2) == 4 * (4 * 100 + 2 * 100 + 2 * 4 + 2 * 2 * 4)


def test_config_4_takes_the_kernel():
    assert takes(_card(192, 1024), _card(1024, 1024), _card(192, 1024), 1)
    assert cluster_size(192, 1024) in cuda_online_sweep.CLUSTERS
    assert smem_bytes(192, 1024, cluster_size(192, 1024)) <= \
        _build.SMEM_PER_BLOCK


def _largest_fitting_K(p):
    K = 2
    while cluster_size(p, 2 * K) is not None:
        K *= 2
    lo, hi = K, 2 * K          # fits at lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if cluster_size(p, mid) is not None else (lo, mid)
    return lo


@pytest.mark.parametrize("case", [
    "cpu", "float64", "too-large", "K=1", "B-shape", "A-shape",
    "two-gpus", "negative-sweeps", "one-cpu"])
def test_takes_refuses_outside_the_envelope(case):
    p, K = 192, 1024
    D, A, B = _card(p, K), _card(K, K), _card(p, K)
    n = 1
    if case == "cpu":
        D, A, B = _cpu(p, K), _cpu(K, K), _cpu(p, K)
    elif case == "float64":
        A = _card(K, K, dtype=torch.float64)
    elif case == "too-large":
        K = _largest_fitting_K(p) + 1
        assert takes(_card(p, K - 1), _card(K - 1, K - 1), _card(p, K - 1),
                     n)
        D, A, B = _card(p, K), _card(K, K), _card(p, K)
    elif case == "K=1":
        D, A, B = _card(p, 1), _card(1, 1), _card(p, 1)
    elif case == "B-shape":
        B = _card(p + 1, K)
    elif case == "A-shape":
        A = _card(K, K + 1)
    elif case == "two-gpus":
        B = _card(p, K, device="cuda:1")
    elif case == "negative-sweeps":
        n = -1
    else:
        A = _cpu(K, K)
    assert not takes(D, A, B, n)


def test_the_cluster_adapts_to_the_shape():
    # the smallest cluster whose CTAs hold at most two rows a warp, else
    # the largest that fits: at config 4, 16 CTAs of 12 rows
    assert cluster_size(192, 1024) == 16
    assert cluster_size(12, 24) == 2
    assert cluster_size(64, 1024) == 4
    assert cluster_size(16 * 16 + 1, 64) == 16       # 17 rows a CTA
    # a cluster of 16 holds 16 times the rows of one CTA's shared memory:
    # at K=1024 the kernel takes p up to 16 x 54 (55 rows of 4 KB and the
    # column buffers pass 232,448 bytes)
    assert cluster_size(16 * 54, 1024) == 16
    assert cluster_size(16 * 54 + 1, 1024) is None


def test_the_wrapper_refuses_cuda_tensors_outside_the_envelope(monkeypatch):
    D, A, B = statistics(3)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(ValueError, match="kernel takes float32"):
        online_sweep_fused(D.double(), A.double(), B.double(), 1)


def test_the_learner_hands_each_sweep_to_the_kernel(monkeypatch):
    """Where ``takes`` holds, ``minibatch_update``'s sweep is one call of
    the kernel's wrapper, which counts one launch: one a minibatch of
    ``fit`` and of ``partial_fit``.  The stand-in runs the plain loop, so
    the dictionary is the CPU run's bit for bit."""
    calls = []

    def stand_in(D, A, B, n_sweeps):
        calls.append(n_sweeps)
        lt.ops._launch.count("online_sweep")
        return online_sweep_reference(D, A, B, n_sweeps)

    rng = np.random.default_rng(0)
    X = rng.standard_normal((12, 4 * 32)).astype(np.float32)
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    cfg = lt.OnlineDLConfig(K=24, lam=0.1, batch_size=32, chunk_batches=2)
    want = lt.OnlineDictionaryLearner(cfg, device="cpu").fit(X, seed=1).D_
    monkeypatch.setattr(cuda_online_sweep, "takes", lambda *a: True)
    monkeypatch.setattr(cuda_online_sweep, "online_sweep_fused", stand_in)
    lt.reset_launch_counts()
    got = lt.OnlineDictionaryLearner(cfg, device="cpu").fit(X, seed=1).D_
    assert calls == [cfg.n_sweeps] * 4
    assert lt.launch_counts()["online_sweep"] == 4
    assert torch.equal(got, want)
    learner = lt.OnlineDictionaryLearner(cfg, device="cpu")
    learner.partial_fit(X[:, :32])
    learner.partial_fit(X[:, 32:64])
    assert len(calls) == 6 and lt.launch_counts()["online_sweep"] == 6
