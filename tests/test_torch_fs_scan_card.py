"""The feature-sign search kernel (``ops/cuda_fs_scan.py``, csrc/fs_scan.cu)
against its plain version, ``solvers.lasso._fs_init`` + ``_fs_loop``, on the
card, at config 4's width (p=192, K=1024, lam=0.15) on unit-norm lanes drawn
with numpy.  The kernel stops each lane's refinements and CG on that lane's
own test, where the plain loop runs them while any lane needs them, so the
two agree up to rounding: they are held to each other by objective, KKT and
the done flags, lane by lane.  The seeded entry, which runs feature_sign's
loop after K6 (``fs_scan_seeded``), is held the same way against the plain
loop from the same K6 handoff (``fs_scan_seeded_reference``) over config
4's data dictionary, at the lasso cell's block and the stream cell's
minibatch, and the empty-start entry against the build before the seeded
entry was added, bit for bit.  Skipped without a CUDA GPU.  Imports no JAX,
so that the card can run it without this directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fs_scan_card.py
"""

import hashlib

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.ops.cuda_fs import fs_cold_fused, gram_inputs
from lyssandra_tpu_torch.ops.cuda_fs_scan import (
    fs_scan_fused,
    fs_scan_fused_reference,
    fs_scan_seeded,
    fs_scan_seeded_reference,
)
from lyssandra_tpu_torch.solvers.lasso import _fs_init, host_syncs

P, K, LAM = 192, 1024, 0.15
TUN = 28                  # feature_sign's cold start on a GPU
# the lasso cell's limits (portbench/workloads/lasso-c4.encode.json)
KKT_MAX, KKT_MEDIAN, GAP_MAX, GAP_MEDIAN = 0.02, 5e-5, 2e-3, 2e-9
# sha256 of the empty-start entry's (Gamma, done, overflow) on config 4's
# first 1,024 patches, from the build of csrc/fs_scan.cu before the seeded
# entry (tools/fs_seeded_ab.py --parent, on an H100 80GB HBM3)
EMPTY_START_SHA256 = (
    "bc0c51029ed28ccf36d4c62043769a9713fc4d3e0bdedf2b78ef59ef95167be1")


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


@pytest.fixture(scope="module")
def config4():
    """Config 4's data (chip_smoke.config4_problem): 16,384 unit-norm 8x8
    colour patches of the four stand-in images, and a dictionary of 1,024
    of them drawn with default_rng(0), both float32 on the host."""
    from lyssandra_tpu_torch.utils.datasets import (
        patch_dataset, synthetic_color_image,
    )

    imgs = [synthetic_color_image(k, 256, seed=s)
            for s, k in enumerate(("texture", "mix", "smooth", "edges"))]
    X = patch_dataset(imgs, p=8, n_patches=16384, seed=1).astype(np.float32)
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-8)
    nonzero = np.where(np.linalg.norm(X, axis=0) > 0.5)[0]
    cols = np.random.default_rng(0).choice(nonzero, K, replace=False)
    D = X[:, cols].copy()
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    return D, X


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


def _on(card, D, X, n, last=True):
    """(D, the last (or first) n patches of X) on the card."""
    Xn = X[:, -n:] if last else X[:, :n]
    return (torch.as_tensor(D, device=card),
            torch.as_tensor(np.ascontiguousarray(Xn), device=card))


@pytest.mark.card
@pytest.mark.parametrize("tun", [TUN, 4], ids=["tun-28", "tun-4"])
@pytest.mark.parametrize("n", [2048, 4096])
def test_seeded_kernel_matches_the_plain_loop_from_k6s_handoff(card, config4,
                                                                n, tun):
    # K6 at 28 steps, as feature_sign runs it, leaves every lane of this
    # data done; at 4 it leaves most to the loop
    D, X = _on(card, *config4, n)
    products = gram_inputs(D, X)
    seed = fs_cold_fused(D, X, lam=LAM, t_unroll=tun, products=products)
    G, done, ovf, iters = fs_scan_seeded(D, X, seed, lam=LAM,
                                         products=products)
    Gp, donep, ovfp, itp = fs_scan_seeded_reference(D, X, seed, lam=LAM)
    torch.cuda.synchronize()
    assert G.shape == (K, n) and iters.shape == (n,)
    entry = seed[5]
    assert bool(entry.any()) and not bool(iters[entry].any())
    # after 4 steps the loop itself runs: most lanes, many iterations
    assert tun == TUN or (float(entry.float().mean()) < 0.5
                          and int(iters.max()) > 0)
    # the lanes done on entry keep their seed codes, bit for bit
    assert torch.equal(G[:, entry], Gp[:, entry])
    g = gap(D, X, G, Gp)
    assert float(g.median()) <= GAP_MEDIAN and float(g.max()) <= GAP_MAX
    breach = kkt_breach(D, X, G)[done & ~ovf]
    assert float(breach.median()) <= KKT_MEDIAN
    assert float(breach.max()) <= KKT_MAX
    assert float((done == donep).float().mean()) >= 0.99
    assert float((ovf == ovfp).float().mean()) >= 0.99
    assert abs(int(iters.max()) - int(itp.max())) <= 2


@pytest.mark.card
def test_seeded_from_the_empty_set_is_the_empty_start_entry(card, config4):
    # the seeded entry from _fs_init's state reads the same first violator
    # and runs the same loop: the same bits as the empty-start entry
    D, X = _on(card, *config4, 1024, last=False)
    products = gram_inputs(D, X)
    seed = _fs_init(products[0], LAM, 64)[:6]
    G, done, ovf, _ = fs_scan_seeded(D, X, seed, lam=LAM, max_iter=60,
                                     products=products)
    Ge, donee, ovfe, _ = fs_scan_fused(D, X, lam=LAM)
    assert torch.equal(G, Ge) and torch.equal(done, donee)
    assert torch.equal(ovf, ovfe)


@pytest.mark.card
def test_empty_start_entry_is_the_builds_before_the_seed(card, config4):
    D, X = _on(card, *config4, 1024, last=False)
    G, done, ovf, _ = fs_scan_fused(D, X, lam=LAM)
    h = hashlib.sha256()
    for t in (G, done, ovf):
        h.update(t.contiguous().cpu().numpy().tobytes())
    assert h.hexdigest() == EMPTY_START_SHA256


@pytest.mark.card
def test_feature_sign_launches_the_seeded_entry_once_and_reads_once(
        card, config4):
    D, X = _on(card, *config4, 2048)
    lt.reset_launch_counts()
    s0 = host_syncs()
    res = lt.feature_sign(D, X, LAM, full_result=True, polish=False)
    reads = host_syncs() - s0
    counts = lt.launch_counts()
    assert counts["fs_scan_seeded"] == 1 and counts["fs_cold"] == 1
    assert counts["gram"] == 2 and counts["fs_scan"] == 0
    assert sum(counts.values()) == 4
    # one read brings n_iter (with the polish, its gate too)
    assert reads == 1
    assert TUN <= res.n_iter <= TUN + 100
    s0 = host_syncs()
    lt.feature_sign(D, X, LAM)
    # where the gate is open, the polish reads it once more
    assert host_syncs() - s0 == 1 + int(not bool(
        (res.done & ~res.overflow).all()))
