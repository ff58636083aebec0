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
done (N,) bool.  ``gram_inputs`` makes the kernel's inputs alpha0 and G,
and the wrapper takes them as ``products``, so that the search kernel that
takes the handoff (``ops/cuda_fs_scan.py``) reads the same ones.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import _launch
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


def takes(D, X, t_unroll: int, n_refine: int = 2) -> bool:
    """Whether ``fs_cold_fused`` launches its kernel for (D, X): a float32
    pair on the GPU whose (p, K, t_unroll) the kernel supports, and
    n_refine >= 0."""
    return (_launch.kernel_pair(D, X) and n_refine >= 0
            and kernel_supports(D.shape[0], D.shape[1], t_unroll))


def kkt_thresholds(lam: float) -> tuple[float, float]:
    """The feature-sign kernels' KKT thresholds for lam: the activation
    threshold and the done threshold, rounded to float32 once in the
    kernel, as the plain version's comparisons with a Python float round
    them."""
    return lam * (1.0 + 1e-4) + 1e-7, lam + 1e-12


def gram_inputs(D: torch.Tensor, X: torch.Tensor):
    """The Gram-form kernels' inputs for (D, X): (alpha0 = X^T D (N, K),
    G = D^T D (K, K)), by the product kernel on the GPU."""
    return gram(X, D), gram(D, D, symmetric=True)


def fs_cold_fused(D: torch.Tensor, X: torch.Tensor, *, lam, t_unroll: int,
                  n_refine: int = 2, products=None):
    """Fused feature-sign cold start over the columns of X (p, N) with
    dictionary D (p, K).  Returns (idx, mask, theta, gact, gr, done).

    On the GPU the kernel works in the Gram form: the product kernel
    (``cuda_gram.gram``) computes alpha0 = X^T D and G = D^T D first, and
    the cold-start kernel reads only those.  ``products``: that pair where
    the caller made it (``gram_inputs(D, X)``)."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return fs_cold_fused_reference(D, X, lam=lam, t_unroll=t_unroll,
                                       n_refine=n_refine)
    tun = int(t_unroll)
    _launch.check_pair(
        D, X, takes,
        f"1 <= t_unroll <= {MAX_TUN}, n_refine >= 0 and a lane state that "
        "fits shared memory", t_unroll=tun, n_refine=n_refine)
    K = D.shape[1]
    N = X.shape[1]
    dev = X.device
    idx = torch.zeros((N, tun), dtype=torch.int32, device=dev)
    mask = torch.zeros((N, tun), dtype=torch.bool, device=dev)
    theta = torch.zeros((N, tun), dtype=torch.float32, device=dev)
    gact = torch.zeros((N, tun), dtype=torch.float32, device=dev)
    gr = torch.empty((N, K), dtype=torch.float32, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return idx, mask, theta, gact, gr, done
    A0, G = gram_inputs(D, X) if products is None else products
    lam = float(lam)
    warps = min(_MAX_WARPS, _build.SMEM_PER_BLOCK // lane_smem_bytes(K, tun))
    _launch.launch(
        "fs_cold", "lyssa_fs_cold", A0.data_ptr(), G.data_ptr(), K, N, tun,
        int(n_refine), lam, *kkt_thresholds(lam), warps, idx.data_ptr(),
        mask.data_ptr(), theta.data_ptr(), gact.data_ptr(), gr.data_ptr(),
        done.data_ptr(), like=X)
    return idx, mask, theta, gact, gr, done
