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
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops.cuda_gram import gram
from lyssandra_tpu_torch.solvers.lasso import _fs_init, _fs_loop

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
    if not (X.is_cuda and D.is_cuda and X.device == D.device):
        raise ValueError(
            f"no kernel for D on {D.device} and X on {X.device}")
    if X.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError(f"kernel takes float32, got {D.dtype}, {X.dtype}")
    if X.ndim != 2 or D.ndim != 2 or X.shape[0] != D.shape[0]:
        raise ValueError(
            f"D (p, K) and X (p, N) expected, got {tuple(D.shape)} and "
            f"{tuple(X.shape)}")
    p, K = D.shape
    N = X.shape[1]
    if (not kernel_supports(p, K, max_active)
            or min(max_iter, max_inner, max_cg) < 0):
        raise ValueError(
            f"kernel takes 1 <= max_active <= {MAX_ACTIVE}, a lane state "
            f"that fits shared memory and counts >= 0; got p={p}, K={K}, "
            f"max_active={max_active}, max_iter={max_iter}, "
            f"max_inner={max_inner}, max_cg={max_cg}")
    dev = X.device
    gamma = torch.zeros((N, K), dtype=torch.float32, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return gamma.T, done, overflow, gamma
    A0 = gram(X, D)                     # (N, K) alpha0 = X^T D
    G = gram(D, D, symmetric=True)      # (K, K)
    lam = float(lam)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # the thresholds rounded to float32 once, as the plain version's
        # comparisons with a Python float round them
        code = lib.lyssa_fs_scan(
            A0.data_ptr(), G.data_ptr(), K, N, int(max_active),
            int(max_iter), int(max_inner), int(max_cg), lam,
            lam * (1.0 + 1e-4) + 1e-7, lam + 1e-12, gamma.data_ptr(),
            done.data_ptr(), overflow.data_ptr(), stream)
    _build.check(lib, code, "fs_scan kernel")
    fs_scan_fused.launches += 1
    return gamma.T, done, overflow, A0


# kernel launches
fs_scan_fused.launches = 0
