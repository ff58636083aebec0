"""The online sweep kernel (``ops/cuda_online_sweep.py``,
csrc/online_sweep.cu) on the card: against the sweep in float64 at config
4's width (p=192, K=1024) and at odd shapes (p not a multiple of the
cluster, K not a multiple of 32 or of 4, dead atoms, two sweeps), within
the online check's atom limits (1e-5 largest, 1e-6 median distance);
bit for bit equal over two calls; its inputs unchanged; one launch on the
``online_sweep`` counter a call, and one through the learner's sweep.
Skipped without a CUDA GPU.  Imports no JAX, so that the card can run it
without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_online_sweep_card.py
"""

import importlib

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.ops import cuda_online_sweep
from lyssandra_tpu_torch.ops.cuda_online_sweep import (
    online_sweep_fused,
    online_sweep_reference,
)

online = importlib.import_module("lyssandra_tpu_torch.dict_learning.online")

ATOM_MAX, ATOM_MEDIAN = 1e-5, 1e-6     # the online check's atom limits


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card)")
    return torch.device("cuda", 0)


def problem(seed, p, K, n=4096, s=8, dead=0, dev="cpu"):
    """Unit-norm atoms D (p, K) and Mairal's statistics of n signals, each
    a noisy combination of s atoms of another dictionary: A = Gamma
    Gamma^T, B = X Gamma^T.  ``dead`` atoms are used by no signal, so
    their A_kk is 0."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Dt = rng.standard_normal((p, K))
    Dt /= np.linalg.norm(Dt, axis=0, keepdims=True)
    live = rng.permutation(K)[dead:]
    G = np.zeros((K, n))
    for i in range(n):
        G[rng.choice(live, s, replace=False), i] = rng.standard_normal(s)
    X = Dt @ G + 0.05 * rng.standard_normal((p, n))
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    f32 = [torch.as_tensor(v, dtype=torch.float32, device=dev)
           for v in (D, G @ G.T, X @ G.T)]
    return f32


def atom_gaps(got, D, A, B, n_sweeps):
    """Per-atom distances of the kernel's sweep from the sweep in float64
    of the same float32 inputs."""
    want = online_sweep_reference(D.double(), A.double(), B.double(),
                                  n_sweeps)
    return torch.linalg.vector_norm(got.double() - want, dim=0)


@pytest.mark.card
@pytest.mark.parametrize("p,K,dead,n_sweeps", [
    (192, 1024, 0, 1),      # config 4
    (192, 1024, 24, 2),     # with dead atoms, two sweeps
    (61, 200, 3, 2),        # p a multiple of no cluster, K of no 32
    (7, 97, 5, 1),          # K odd: the 4-byte column fetch
    (300, 64, 0, 3),
])
def test_kernel_matches_the_float64_sweep(card, p, K, dead, n_sweeps):
    D, A, B = problem(p * K + dead, p, K, dead=dead, dev=card)
    got = online_sweep_fused(D, A, B, n_sweeps)
    gaps = atom_gaps(got, D, A, B, n_sweeps)
    assert float(gaps.max()) <= ATOM_MAX and \
        float(gaps.median()) <= ATOM_MEDIAN, (float(gaps.max()),
                                              float(gaps.median()))
    assert float(torch.linalg.vector_norm(got, dim=0).max()) <= 1 + 1e-6
    dead_k = torch.diagonal(A) < 1e-10
    assert int(dead_k.sum()) == dead
    assert torch.equal(got[:, dead_k], D[:, dead_k])   # dead atoms stay


@pytest.mark.card
@pytest.mark.parametrize("cluster", cuda_online_sweep.CLUSTERS[1:])
def test_every_cluster_size_at_config_4(card, cluster):
    D, A, B = problem(4, 192, 1024, dev=card)
    got = online_sweep_fused(D, A, B, 1, cluster=cluster)
    gaps = atom_gaps(got, D, A, B, 1)
    assert float(gaps.max()) <= ATOM_MAX and \
        float(gaps.median()) <= ATOM_MEDIAN


@pytest.mark.card
def test_two_calls_agree_bit_for_bit_and_leave_the_inputs(card):
    D, A, B = problem(5, 192, 1024, dead=7, dev=card)
    noise = 1e-3 * torch.randn(A.shape, generator=torch.Generator(
        ).manual_seed(5))
    A = A + noise.fill_diagonal_(0.0).to(card)     # not symmetric
    before = [t.clone() for t in (D, A, B)]
    one = online_sweep_fused(D, A, B, 2)
    two = online_sweep_fused(D, A, B, 2)
    assert torch.equal(one, two)
    for t, t0 in zip((D, A, B), before):
        assert torch.equal(t, t0)
    gaps = atom_gaps(one, D, A, B, 2)
    assert float(gaps.max()) <= ATOM_MAX


@pytest.mark.card
def test_one_launch_a_call_and_through_the_learner(card):
    D, A, B = problem(6, 192, 1024, dev=card)
    assert cuda_online_sweep.takes(D, A, B, 1)
    lt.reset_launch_counts()
    online_sweep_fused(D, A, B, 1)
    online_sweep_fused(D, A, B, 2)
    assert lt.launch_counts()["online_sweep"] == 2
    got = online._dict_update_body(D, A, B, 1)
    counts = lt.launch_counts()
    assert counts["online_sweep"] == 3 and sum(counts.values()) == 3
    assert torch.equal(got, online_sweep_fused(D, A, B, 1))
    # outside the envelope the learner's sweep takes the plain loop
    lt.reset_launch_counts()
    got64 = online._dict_update_body(D.double(), A.double(), B.double(), 1)
    assert lt.launch_counts()["online_sweep"] == 0
    assert float(atom_gaps(got, D, A, B, 1).max()) <= ATOM_MAX
    assert float((got.double() - got64).abs().max()) <= ATOM_MAX
