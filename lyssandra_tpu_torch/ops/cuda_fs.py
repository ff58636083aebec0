"""Fused feature-sign cold start: the first Tun activations of every
signal's lasso solve in one kernel (``lyssandra_tpu.ops.pallas_fs``
counterpart).

``fs_cold_fused`` launches the CUDA kernel ``csrc/fs_cold.cu`` (in the Gram
form, after ``csrc/gram.cu``'s alpha0 = X^T D and G = D^T D) for tensors
on the GPU and runs its plain PyTorch version, ``fs_cold_fused_reference``
(``solvers.lasso._fs_unrolled_state`` without the handoff padding), for
tensors on the CPU.  Outputs: idx (N, Tun) int32, mask (N, Tun) bool,
theta (N, Tun), gact (N, Tun), gr (N, K) — the gradient at the handoff
point, zero at the active slots, as the feature-sign loop carries it — and
done (N,) bool.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops.cuda_gram import gram
from lyssandra_tpu_torch.solvers.lasso import _fs_unrolled_state

MAX_TUN = 32            # one warp thread per slot
_MAX_WARPS = 4          # lanes (warps) per block (csrc/fs_cold.cu's WARPS)


def fs_cold_fused_reference(D: torch.Tensor, X: torch.Tensor, *, lam,
                            t_unroll: int, n_refine: int = 2):
    """Plain version of the kernel: (idx, mask, theta, gact, gr, done)."""
    st = _fs_unrolled_state(D.T, X.T, X.T @ D, float(lam),
                            t_unroll=int(t_unroll), n_refine=int(n_refine),
                            max_active=int(t_unroll))
    return st[:6]


def lane_smem_bytes(K: int, t_unroll: int) -> int:
    """Shared memory one lane (warp) of the kernel holds (the formula of
    ``lane_floats`` in csrc/fs_cold.cu): the compact Gram (odd stride),
    four 32-wide broadcast vectors and the 32 slot indices, one bit per
    atom for the active set, and the lane's alpha0 row."""
    return 4 * (t_unroll * (t_unroll | 1) + 5 * 32 + -(-K // 32) + K)


def kernel_supports(p: int, K: int, t_unroll: int) -> bool:
    """Whether the kernel takes signals of length p over K atoms at depth
    t_unroll (one slot per thread of a warp, the lane's state in shared
    memory; p only sets the product kernel's work)."""
    return (p >= 1 and K >= 1 and 1 <= t_unroll <= MAX_TUN
            and lane_smem_bytes(K, t_unroll) <= _build.SMEM_PER_BLOCK)


def fs_cold_fused(D: torch.Tensor, X: torch.Tensor, *, lam, t_unroll: int,
                  n_refine: int = 2):
    """Fused feature-sign cold start over the columns of X (p, N) with
    dictionary D (p, K).  Returns (idx, mask, theta, gact, gr, done).

    On the GPU the kernel works in the Gram form: the product kernel
    (``cuda_gram.gram``) computes alpha0 = X^T D and G = D^T D first, and
    the cold-start kernel reads only those."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return fs_cold_fused_reference(D, X, lam=lam, t_unroll=t_unroll,
                                       n_refine=n_refine)
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
    tun = int(t_unroll)
    if not kernel_supports(p, K, tun) or n_refine < 0:
        raise ValueError(
            f"kernel takes 1 <= t_unroll <= {MAX_TUN}, n_refine >= 0 and a "
            f"lane state that fits shared memory; got p={p}, K={K}, "
            f"t_unroll={tun}, n_refine={n_refine}")
    dev = X.device
    idx = torch.zeros((N, tun), dtype=torch.int32, device=dev)
    mask = torch.zeros((N, tun), dtype=torch.bool, device=dev)
    theta = torch.zeros((N, tun), dtype=torch.float32, device=dev)
    gact = torch.zeros((N, tun), dtype=torch.float32, device=dev)
    gr = torch.empty((N, K), dtype=torch.float32, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return idx, mask, theta, gact, gr, done
    A0 = gram(X, D)                     # (N, K) alpha0 = X^T D
    G = gram(D, D, symmetric=True)      # (K, K)
    lam = float(lam)
    warps = min(_MAX_WARPS, _build.SMEM_PER_BLOCK // lane_smem_bytes(K, tun))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # the thresholds rounded to float32 once, as the plain version's
        # comparisons with a Python float round them
        code = lib.lyssa_fs_cold(
            A0.data_ptr(), G.data_ptr(), K, N, tun, int(n_refine), lam,
            lam * (1.0 + 1e-4) + 1e-7, lam + 1e-12, warps, idx.data_ptr(),
            mask.data_ptr(), theta.data_ptr(), gact.data_ptr(),
            gr.data_ptr(), done.data_ptr(), stream)
    _build.check(lib, code, "fs_cold kernel")
    fs_cold_fused.launches += 1
    return idx, mask, theta, gact, gr, done


# kernel launches (K6)
fs_cold_fused.launches = 0
