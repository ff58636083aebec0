"""The online learner's atom sweep in one launch
(``dict_learning.online._dict_update_body``).

``online_sweep_fused`` launches the CUDA kernel ``csrc/online_sweep.cu`` for
tensors on the GPU and runs its plain PyTorch version,
``online_sweep_reference``, for tensors on the CPU.  It replaces no Pallas
kernel: the JAX package runs the sweep as a ``lax.scan``.  The kernel
computes what the plain loop computes, atom by atom and in order, in
float32; its products and norms sum in another order, so the two agree up
to rounding.  ``takes`` is the kernel's envelope: the sweep takes the plain
loop wherever it is false.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import _launch

CLUSTERS = (2, 4, 8, 16)   # CTAs a cluster: 16 with the non-portable size
MAX_WARPS = 8              # warps a CTA (csrc/online_sweep.cu's MAXW)
ROWS_A_CTA = 2 * MAX_WARPS  # rows a CTA holds where a cluster allows


def online_sweep_reference(D: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                           n_sweeps: int) -> torch.Tensor:
    """Plain version of the kernel: ``n_sweeps`` sweeps of atom updates over
    k = 0..K-1 in order, each seeing the atoms before it; an atom with
    A_kk < 1e-10 (no use yet) keeps its value.  Returns a new D; the inputs
    are not changed."""
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


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def smem_bytes(p: int, K: int, c: int) -> int:
    """Shared memory one CTA of a cluster of c holds (the formula of
    ``sweep_floats`` in csrc/online_sweep.cu): its r = ceil(p / c) rows of
    D at a row stride of K padded to 4, two buffers of A's column and of
    the CTA's entries of B's, and two slots of the cluster's partial
    norms, one a warp of each CTA."""
    r = -(-p // c)
    warps = min(max(r, 1), MAX_WARPS)
    return 4 * (r * _pad4(K) + 2 * _pad4(K) + 2 * _pad4(r) + 2 * c * warps)


def cluster_size(p: int, K: int) -> int | None:
    """The cluster the kernel runs at (p, K): the smallest of ``CLUSTERS``
    whose CTAs fit a block's shared memory and hold at most
    ``ROWS_A_CTA`` rows of D each, else the largest that fits; None where
    none fits.  A CTA's time an atom grows with the rows each of its warps
    multiplies: at config 4 (p=192, K=1024) a sweep took 4.19, 2.87 and
    2.44 ms at c = 4, 8 and 16, 6, 3 and 2 rows a warp (H100, PERF.md)."""
    fits = [c for c in CLUSTERS
            if smem_bytes(p, K, c) <= _build.SMEM_PER_BLOCK]
    if not fits:
        return None
    return next((c for c in fits if -(-p // c) <= ROWS_A_CTA), fits[-1])


def takes(D, A, B, n_sweeps: int) -> bool:
    """Whether ``online_sweep_fused`` launches its kernel for (D, A, B): D
    and B (p, K), A (K, K), all float32 on one GPU, K >= 2, n_sweeps >= 0,
    and D's rows fit the shared memory of a cluster of at most 16 CTAs."""
    if not (D.is_cuda and A.is_cuda and B.is_cuda
            and D.device == A.device == B.device
            and _launch.kernel_types("cuda", D.dtype, A.dtype, B.dtype)):
        return False
    if len(D.shape) != 2:
        return False
    p, K = D.shape
    return (tuple(B.shape) == (p, K) and tuple(A.shape) == (K, K)
            and p >= 1 and K >= 2 and n_sweeps >= 0
            and cluster_size(p, K) is not None)


def online_sweep_fused(D: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                       n_sweeps: int, *, cluster: int | None = None
                       ) -> torch.Tensor:
    """``n_sweeps`` atom sweeps of D (p, K) with the statistics A (K, K) and
    B (p, K), in one launch on the GPU.  Returns a new D; the inputs are
    not changed.  ``cluster``: the CTAs a cluster, one of ``CLUSTERS``
    whose CTAs fit, in place of ``cluster_size(p, K)`` (for timing)."""
    if not (D.is_cuda or A.is_cuda or B.is_cuda):
        return online_sweep_reference(D, A, B, n_sweeps)
    if not takes(D, A, B, n_sweeps):
        raise ValueError(
            "kernel takes float32 D (p, K), A (K, K), B (p, K) on one GPU, "
            "K >= 2, n_sweeps >= 0 and rows that fit a cluster's shared "
            f"memory; got D {tuple(D.shape)} {D.dtype} on {D.device}, A "
            f"{tuple(A.shape)} {A.dtype} on {A.device}, B {tuple(B.shape)} "
            f"{B.dtype} on {B.device}, n_sweeps={n_sweeps}")
    p, K = D.shape
    c = cluster_size(p, K) if cluster is None else cluster
    if c not in CLUSTERS or smem_bytes(p, K, c) > _build.SMEM_PER_BLOCK:
        raise ValueError(f"no cluster of {c} CTAs at p={p}, K={K}")
    D = D.contiguous()
    B = B.contiguous()
    AT = A.t().contiguous()      # column k of A as a contiguous row
    out = torch.empty_like(D)
    _launch.launch("online_sweep", "lyssa_online_sweep", D.data_ptr(),
                   AT.data_ptr(), B.data_ptr(), out.data_ptr(), p, K,
                   int(n_sweeps), c, like=D)
    return out
