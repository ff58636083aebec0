"""Fused OMP: all pursuit steps of each signal in one kernel
(``lyssandra_tpu.ops.pallas_omp`` counterpart).

``omp_fused`` launches the CUDA kernel ``csrc/omp_fused.cu`` — fixed-T
mode or error-stopped mode with per-lane early exit — for tensors on the
GPU, and runs its plain PyTorch version, ``omp_fused_reference``, for
tensors on the CPU.  Outputs follow ``GreedyResult``: idx (N, T) int32,
gamma (N, T), err (N,) = the final ||r||^2 of the explicit residual, and
nsel (N,) int32; entries past nsel are zero.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.solvers.greedy import _omp_impl

MAX_P = 512
_MAX_WARPS = 4          # lanes (warps) per block


def omp_fused_reference(D: torch.Tensor, X: torch.Tensor, *, T: int,
                        eps: float = 0.0, eps_mode: bool = False):
    """Plain version of the kernel: the batched residual-form OMP with the
    same selection tie-break and freeze rules."""
    return tuple(_omp_impl(D, X, eps, T=T, eps_mode=eps_mode))


def lane_smem_bytes(p: int, T: int) -> int:
    """Shared memory one lane (warp) of the kernel holds: x, r, the T
    selected atoms, the T x T factor and five T-vectors."""
    return 4 * (2 * p + T * p + T * T + 6 * T)


def kernel_supports(p: int, T: int) -> bool:
    """Whether the kernel takes signals of length p at T steps."""
    return 1 <= p <= MAX_P and T >= 1 and \
        lane_smem_bytes(p, T) <= _build.SMEM_PER_BLOCK


def omp_fused(D: torch.Tensor, X: torch.Tensor, *, T: int, eps: float = 0.0,
              eps_mode: bool = False):
    """Fused OMP over the columns of X (p, N) with dictionary D (p, K).
    Returns (idx, gamma, err, nsel)."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return omp_fused_reference(D, X, T=T, eps=eps, eps_mode=eps_mode)
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
    if not kernel_supports(p, T):
        raise ValueError(
            f"kernel takes p <= {MAX_P} and a T whose per-lane state fits "
            f"shared memory; got p={p}, T={T}")
    dev = X.device
    idx = torch.zeros((N, T), dtype=torch.int32, device=dev)
    gamma = torch.zeros((N, T), dtype=torch.float32, device=dev)
    err = torch.empty((N,), dtype=torch.float32, device=dev)
    nsel = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return idx, gamma, err, nsel
    D = D.contiguous()
    X = X.contiguous()
    warps = min(_MAX_WARPS, _build.SMEM_PER_BLOCK // lane_smem_bytes(p, T))
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lyssa_omp_fused(
            X.data_ptr(), D.data_ptr(), p, K, N, T, float(eps * eps),
            int(eps_mode), warps, idx.data_ptr(), gamma.data_ptr(),
            err.data_ptr(), nsel.data_ptr(), stream)
    _build.check(lib, code, "omp_fused kernel")
    if eps_mode:
        omp_fused.launches_eps += 1
    else:
        omp_fused.launches_t += 1
    return idx, gamma, err, nsel


# kernel launches, one count per mode: fixed T (K1) and error-stopped (K2)
omp_fused.launches_t = 0
omp_fused.launches_eps = 0
