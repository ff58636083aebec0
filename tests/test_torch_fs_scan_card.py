"""The feature-sign search kernel (``ops/cuda_fs_scan.py``, csrc/fs_scan.cu)
against its plain version, ``solvers.lasso._fs_init`` + ``_fs_loop``, on the
card, at config 4's width (p=192, K=1024, lam=0.15) on unit-norm lanes drawn
with numpy.  The kernel stops each lane's refinements and CG on that lane's
own test, where the plain loop runs them while any lane needs them, so the
two agree up to rounding: they are held to each other by objective, KKT and
the done flags, lane by lane.  Skipped without a CUDA GPU.  Imports no JAX,
so that the card can run it without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fs_scan_card.py
"""

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.ops.cuda_fs_scan import (
    fs_scan_fused,
    fs_scan_fused_reference,
)
from lyssandra_tpu_torch.solvers.lasso import host_syncs

P, K, LAM = 192, 1024, 0.15


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card)")
    return torch.device("cuda", 0)


def problem(seed, n, dev):
    """Unit-norm Gaussian atoms D (P, K) and unit-norm lanes X (P, n), each
    a noisy combination of 2-8 atoms: a lasso whose supports fit 64
    slots."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((P, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    X = 0.05 * rng.standard_normal((P, n))
    for i in range(n):
        s = rng.integers(2, 9)
        X[:, i] += D[:, rng.choice(K, s, replace=False)] @ \
            rng.standard_normal(s)
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    return (torch.as_tensor(D, dtype=torch.float32, device=dev),
            torch.as_tensor(X, dtype=torch.float32, device=dev))


def objectives(D, X, G, lam=LAM):
    """Per-lane ||x - D g||^2 + lam ||g||_1, float64."""
    R = X.double() - D.double() @ G.double()
    return (R * R).sum(dim=0) + lam * G.double().abs().sum(dim=0)


def kkt_breach(D, X, G, lam=LAM):
    """Per lane, the widest breach of the lasso's optimality conditions,
    float64: |grad + lam sign(g)| over the nonzeros, |grad| - lam over the
    zeros (grad = 2 D^T (D g - x))."""
    Gd = G.double()
    grad = 2.0 * (D.double().T @ (D.double() @ Gd - X.double()))
    act = Gd != 0
    on = torch.where(act, (grad + lam * torch.sign(Gd)).abs(), 0.0)
    off = torch.where(act, 0.0, (grad.abs() - lam).clamp_min(0.0))
    return torch.maximum(on, off).amax(dim=0)


def gap(D, X, got, want):
    """Per-lane relative objective gap of the kernel's codes over the
    plain version's."""
    fo, fw = objectives(D, X, got), objectives(D, X, want)
    return (fo - fw) / fw.clamp_min(1e-12)


@pytest.mark.card
@pytest.mark.parametrize("n", [1024, 4096])
def test_kernel_matches_the_plain_loop(card, n):
    D, X = problem(n, n, card)
    G, done, ovf, A0 = fs_scan_fused(D, X, lam=LAM)
    Gp, donep, ovfp, A0p = fs_scan_fused_reference(D, X, lam=LAM)
    torch.cuda.synchronize()
    assert G.shape == (K, n) and done.shape == ovf.shape == (n,)
    assert torch.allclose(A0, A0p, atol=1e-5)
    g = gap(D, X, G, Gp)
    assert float(g.median()) <= 1e-8
    assert float(g.max()) <= 2e-3
    assert float(kkt_breach(D, X, G)[done & ~ovf].median()) <= 5e-5
    assert float((done == donep).float().mean()) >= 0.99
    assert float((ovf == ovfp).float().mean()) >= 0.99
    assert float(done.float().mean()) >= 0.9


@pytest.mark.card
@pytest.mark.parametrize("p,k", [(21, 100), (64, 1000)])
def test_ragged_widths(card, p, k):
    # K below one pass of the gradient, or not a multiple of 32
    rng = np.random.default_rng(k)
    D = rng.standard_normal((p, k))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    X = rng.standard_normal((p, 512))
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    D = torch.as_tensor(D, dtype=torch.float32, device=card)
    X = torch.as_tensor(X, dtype=torch.float32, device=card)
    G, done, ovf, _ = fs_scan_fused(D, X, lam=0.1)
    Gp, donep, ovfp, _ = fs_scan_fused_reference(D, X, lam=0.1)
    g = gap(D, X, G, Gp)
    assert float(g.median()) <= 1e-8 and float(g.max()) <= 2e-3
    assert float((done == donep).float().mean()) >= 0.99
    assert float((ovf == ovfp).float().mean()) >= 0.99


@pytest.mark.card
def test_lanes_done_on_entry(card):
    # |2 D^T x| <= lam on every atom: g = 0 is optimal, no slot is used
    D, X = problem(1, 1024, card)
    X = X * (0.4 * LAM / float((D.T @ X).abs().max()))
    G, done, ovf, _ = fs_scan_fused(D, X, lam=LAM)
    assert bool(done.all()) and not bool(ovf.any())
    assert not bool(G.any())


@pytest.mark.card
def test_lanes_cut_by_max_iter(card):
    D, X = problem(2, 1024, card)
    G, done, ovf, _ = fs_scan_fused(D, X, lam=LAM, max_iter=3)
    Gp, donep, ovfp, _ = fs_scan_fused_reference(D, X, lam=LAM, max_iter=3)
    assert float((done == donep).float().mean()) >= 0.99
    assert float(done.float().mean()) < 0.9          # many lanes cut
    assert int((G != 0).sum(dim=0).max()) <= 3       # one atom an iteration
    g = gap(D, X, G, Gp)
    assert float(g.median()) <= 1e-8 and float(g.abs().max()) <= 2e-3


@pytest.mark.card
def test_lanes_that_overflow(card):
    D, X = problem(3, 1024, card)
    G, done, ovf, _ = fs_scan_fused(D, X, lam=LAM, max_active=4)
    Gp, donep, ovfp, _ = fs_scan_fused_reference(D, X, lam=LAM,
                                                 max_active=4)
    assert bool(ovf.any()) and bool((done | ~ovf).all())
    assert float((ovf == ovfp).float().mean()) >= 0.99
    assert float((done == donep).float().mean()) >= 0.99
    assert int((G != 0).sum(dim=0).max()) <= 4
    g = gap(D, X, G, Gp)
    assert float(g.median()) <= 1e-8 and float(g.max()) <= 2e-3


@pytest.mark.card
def test_feature_sign_scan_launches_once_and_reads_once(card):
    D, X = problem(4, 1024, card)
    lt.reset_launch_counts()
    s0 = host_syncs()
    G = lt.feature_sign_scan(D, X, LAM)
    reads = host_syncs() - s0
    counts = lt.launch_counts()
    assert counts["fs_scan"] == 1 and counts["gram"] == 2
    assert reads <= 1
    Gp, _, _, _ = fs_scan_fused_reference(D, X, lam=LAM)
    assert float(gap(D, X, G, Gp).median()) <= 1e-8
