"""Feature-sign search from the empty active set to every lane's own exit in
one kernel: the in-loop coder of the online learner
(``solvers.lasso.feature_sign_scan``).

``fs_scan_fused`` launches the CUDA kernel ``csrc/fs_scan.cu`` (in the Gram
form, after ``csrc/gram.cu``'s alpha0 = X^T D and G = D^T D) for tensors on
the GPU and runs its plain PyTorch version, ``fs_scan_fused_reference``
(``solvers.lasso._fs_init`` + ``_fs_loop``), for tensors on the CPU.  It
replaces no Pallas kernel: the JAX package runs this loop as a
``lax.while_loop``.  The kernel tests every loop exit per lane, where the
plain loop runs a step while any lane of the batch needs it, so the codes
agree up to rounding.  Outputs: Gamma (K, N), done (N,) bool, overflow
(N,) bool and alpha0 = X^T D (N, K), which the caller's polish reuses.

``fs_scan_seeded`` launches the same kernel's seeded entry: the loop from a
seed's state, the cold start's handoff in ``solvers.lasso.feature_sign``,
to every lane's own exit, where the plain loop runs in segments with a host
read at every exit.  Its plain version, ``fs_scan_seeded_reference``, runs
``_fs_loop`` from that state.  It returns each lane's count of outer
iterations in place of alpha0.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import _launch
from lyssandra_tpu_torch.ops.cuda_fs import gram_inputs, kkt_thresholds
from lyssandra_tpu_torch.solvers.lasso import _fs_init, _fs_loop, _pad_handoff

MAX_ACTIVE = 64         # two slots a thread of one warp


def fs_scan_fused_reference(D: torch.Tensor, X: torch.Tensor, *, lam,
                            max_active: int = 64, max_iter: int = 60,
                            max_inner: int = 6, max_cg: int = 32):
    """Plain version of the kernel: (Gamma, done, overflow, alpha0)."""
    A0 = X.T @ D
    lam = float(lam)
    _, res, _ = _fs_loop(D.T, X.T, A0, lam, _fs_init(A0, lam, max_active),
                         max_active=max_active, max_iter=max_iter,
                         max_inner=max_inner, max_cg=max_cg)
    return res.Gamma, res.done, res.overflow, A0


def lane_smem_bytes(K: int) -> int:
    """Shared memory one lane (a block) of the kernel holds (the formula of
    ``lane_floats`` in csrc/fs_scan.cu): the compact Gram (64, 65), four
    64-wide broadcast vectors, the slot atoms and the active list, a
    16-word exchange area, one bit per atom and the lane's alpha0 row."""
    return 4 * (64 * 65 + 7 * 64 + 16 + -(-K // 32) + K)


def kernel_supports(p: int, K: int, max_active: int) -> bool:
    """Whether the kernel takes signals of length p over K atoms with
    ``max_active`` slots: at most 64 slots, and the lane state fits a
    block's shared memory (p only sets the product kernel's work).  That
    caps K at 51,867, where G = D^T D takes 10.8 GB of the card's 80."""
    return (p >= 1 and K >= 1 and 1 <= max_active <= MAX_ACTIVE
            and lane_smem_bytes(K) <= _build.SMEM_PER_BLOCK)


def takes(D, X, max_active: int = 64, max_iter: int = 60,
          max_inner: int = 6, max_cg: int = 32) -> bool:
    """Whether ``fs_scan_fused`` launches its kernel for (D, X): a float32
    pair on the GPU whose (p, K, max_active) the kernel supports, and
    counts >= 0."""
    return (_launch.kernel_pair(D, X)
            and min(max_iter, max_inner, max_cg) >= 0
            and kernel_supports(D.shape[0], D.shape[1], max_active))


def fs_scan_fused(D: torch.Tensor, X: torch.Tensor, *, lam,
                  max_active: int = 64, max_iter: int = 60,
                  max_inner: int = 6, max_cg: int = 32):
    """Feature-sign search over the columns of X (p, N) with dictionary D
    (p, K), from the empty active set, each lane to its own exit.  Returns
    (Gamma (K, N), done, overflow, alpha0 (N, K)).

    On the GPU the product kernel (``cuda_gram.gram``) computes alpha0 =
    X^T D and G = D^T D first, and the search kernel reads only those."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return fs_scan_fused_reference(
            D, X, lam=lam, max_active=max_active, max_iter=max_iter,
            max_inner=max_inner, max_cg=max_cg)
    _launch.check_pair(
        D, X, takes,
        f"1 <= max_active <= {MAX_ACTIVE}, a lane state that fits shared "
        "memory and counts >= 0", max_active=max_active, max_iter=max_iter,
        max_inner=max_inner, max_cg=max_cg)
    K = D.shape[1]
    N = X.shape[1]
    dev = X.device
    gamma = torch.zeros((N, K), dtype=torch.float32, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return gamma.T, done, overflow, gamma
    A0, G = gram_inputs(D, X)
    lam = float(lam)
    _launch.launch(
        "fs_scan", "lyssa_fs_scan", A0.data_ptr(), G.data_ptr(), K, N,
        int(max_active), int(max_iter), int(max_inner), int(max_cg), lam,
        *kkt_thresholds(lam), gamma.data_ptr(), done.data_ptr(),
        overflow.data_ptr(), like=X)
    return gamma.T, done, overflow, A0


def fs_scan_seeded_reference(D: torch.Tensor, X: torch.Tensor, seed, *,
                             lam, max_active: int = 64, max_iter: int = 100,
                             max_inner: int = 6, max_cg: int = 32):
    """Plain version of the seeded entry: ``_fs_loop`` from the seed's state
    padded to ``max_active`` slots, one outer iteration a call so that each
    lane's count is kept; the same steps as one call of ``max_iter``.
    Returns (Gamma, done, overflow, iters)."""
    A0 = X.T @ D
    lam = float(lam)
    opts = dict(max_active=max_active, max_inner=max_inner, max_cg=max_cg)
    st = _pad_handoff(*seed, max_active=max_active)
    iters = torch.zeros(A0.shape[0], dtype=torch.int32, device=A0.device)
    for _ in range(max_iter):
        running = ~st[5]
        st, _, all_done = _fs_loop(D.T, X.T, A0, lam, st, max_iter=1, **opts)
        if all_done:
            break
        iters += running
    _, res, _ = _fs_loop(D.T, X.T, A0, lam, st, max_iter=0, **opts)
    return res.Gamma, res.done, res.overflow, iters


def fs_scan_seeded(D: torch.Tensor, X: torch.Tensor, seed, *, lam,
                   max_active: int = 64, max_iter: int = 100,
                   max_inner: int = 6, max_cg: int = 32, products=None):
    """Feature-sign search over the columns of X (p, N) with dictionary D
    (p, K) from ``seed`` = (idx, mask, theta, gact, gr, done): Tun <=
    ``max_active`` slots a lane (N, Tun), the gradient there (N, K), zero
    at the active slots, and the lanes already done (N,), as
    ``cuda_fs.fs_cold_fused`` returns them.  Each lane runs to its own exit,
    up to ``max_iter`` outer iterations from the seed.  Returns (Gamma (K,
    N), done, overflow, iters (N,) int32: the outer iterations each lane
    ran).  ``products``: (alpha0, G) where the caller made them
    (``cuda_fs.gram_inputs``), else made here."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return fs_scan_seeded_reference(
            D, X, seed, lam=lam, max_active=max_active, max_iter=max_iter,
            max_inner=max_inner, max_cg=max_cg)
    _launch.check_pair(
        D, X, takes,
        f"1 <= max_active <= {MAX_ACTIVE}, a lane state that fits shared "
        "memory and counts >= 0", max_active=max_active, max_iter=max_iter,
        max_inner=max_inner, max_cg=max_cg)
    K = D.shape[1]
    N = X.shape[1]
    idx, mask, theta, gact, gr, done0 = (
        t.to(dt).contiguous() for t, dt in zip(seed, (
            torch.int32, torch.bool, torch.float32, torch.float32,
            torch.float32, torch.bool)))
    tun = idx.shape[1]
    if not (tun <= max_active and mask.shape == theta.shape == gact.shape
            == idx.shape == (N, tun) and gr.shape == (N, K)
            and done0.shape == (N,)):
        raise ValueError(
            f"a seed of (N, Tun) slots, Tun <= max_active={max_active}, gr "
            f"(N, K) and done (N,) expected for N={N}, K={K}; got "
            f"{[tuple(t.shape) for t in seed]}")
    dev = X.device
    gamma = torch.zeros((N, K), dtype=torch.float32, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((N,), dtype=torch.bool, device=dev)
    iters = torch.zeros((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return gamma.T, done, overflow, iters
    A0, G = gram_inputs(D, X) if products is None else products
    lam = float(lam)
    _launch.launch(
        "fs_scan_seeded", "lyssa_fs_scan_seeded", A0.data_ptr(),
        G.data_ptr(), K, N, int(max_active), tun, int(max_iter),
        int(max_inner), int(max_cg), lam, *kkt_thresholds(lam),
        idx.data_ptr(), mask.data_ptr(), theta.data_ptr(), gact.data_ptr(),
        gr.data_ptr(), done0.data_ptr(), gamma.data_ptr(), done.data_ptr(),
        overflow.data_ptr(), iters.data_ptr(), like=X)
    return gamma.T, done, overflow, iters
