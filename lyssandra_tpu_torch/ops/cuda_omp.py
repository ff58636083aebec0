"""Fused OMP: all pursuit steps of each signal in one kernel
(``lyssandra_tpu.ops.pallas_omp`` counterpart).

``omp_fused`` launches the CUDA kernel ``csrc/omp_fused.cu`` — fixed-T
mode or error-stopped mode with per-lane early exit — for tensors on the
GPU, and runs its plain PyTorch version, ``omp_fused_reference``, for
tensors on the CPU.  Outputs follow ``GreedyResult``: idx (N, T) int32,
gamma (N, T), err (N,) = the final ||r||^2 of the explicit residual, and
nsel (N,) int32; entries past nsel are zero.

The kernel runs OMP in the Gram form: before it, each call builds
G = D^T D with the product kernel (``cuda_gram.gram``, symmetric, one more
launch counted there) and D^T; a block of lanes computes its alpha0 = D^T x
in shared memory, and each step reads the support's rows of G.  The plain
version stays on the residual form, so the two round differently.

alpha0 in shared memory caps K (``kernel_supports``).  Above the cap,
``omp_residual_fused`` launches ``csrc/omp_residual.cu``, the same pursuit
in the residual form: each step streams D once a block, and no state grows
with K.  Its plain version is ``omp_fused_reference`` too.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops.cuda_gram import gram
from lyssandra_tpu_torch.solvers.greedy import _omp_impl

_LANES = (16, 8, 4)     # lanes (warps) a block may carry, most first
_NARROW_K = 256         # K at or below which a block carries at most 8
_BP, _STAGE = 8, 2 * 8 * 512   # csrc/omp_fused.cu's slice of p and its
#                                staging ring of D, in floats


def omp_fused_reference(D: torch.Tensor, X: torch.Tensor, *, T: int,
                        eps: float = 0.0, eps_mode: bool = False):
    """Plain version of the kernel: the batched residual-form OMP with the
    same selection tie-break and freeze rules."""
    return tuple(_omp_impl(D, X, eps, T=T, eps_mode=eps_mode))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def lane_smem_bytes(p: int, K: int, T: int) -> int:
    """Shared memory one lane (warp) of the kernel holds: its column of x
    (p rounded up to the staging slice), alpha0 (K rounded up to 4), the
    T x T factor and six T-vectors."""
    return 4 * (_round_up(p, _BP) + _round_up(K, 4) + T * T + 6 * T)


def block_smem_bytes(p: int, K: int, T: int, lanes: int) -> int:
    """Shared memory a block of ``lanes`` lanes takes: theirs and the
    staging ring of D."""
    return 4 * _STAGE + lanes * lane_smem_bytes(p, K, T)


def block_lanes(p: int, K: int, T: int) -> int:
    """Lanes a block carries: the most of ``_LANES`` whose block fits the
    shared memory a block may have (0: none fits), and at most 8 for
    K <= 256, where smaller blocks ran the denoiser's lanes faster on the
    H100 (PERF.md, section 6)."""
    cap = 8 if K <= _NARROW_K else _LANES[0]
    return next((n for n in _LANES if n <= cap
                 and block_smem_bytes(p, K, T, n) <= _build.SMEM_PER_BLOCK),
                0)


def kernel_supports(p: int, K: int, T: int) -> bool:
    """Whether the kernel takes signals of length p over K atoms at T steps:
    a block of the fewest lanes fits shared memory.  p has no cap of its
    own (it enters the state only as x)."""
    return p >= 1 and K >= 1 and T >= 1 and block_lanes(p, K, T) > 0


def _check_cuda_call(D: torch.Tensor, X: torch.Tensor, T: int,
                     supports) -> None:
    """Raise unless a kernel takes (D, X) at T steps: both float32 on one
    GPU, D (p, K) and X (p, N), and ``supports(p, K, T)``."""
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
    if not supports(p, K, T):
        raise ValueError(
            f"kernel takes a (p, K, T) whose block state fits shared memory; "
            f"got p={p}, K={K}, T={T}")


def _outputs(N: int, T: int, dev):
    """Zeroed idx and gamma (N, T), err and nsel (N,)."""
    return (torch.zeros((N, T), dtype=torch.int32, device=dev),
            torch.zeros((N, T), dtype=torch.float32, device=dev),
            torch.empty((N,), dtype=torch.float32, device=dev),
            torch.empty((N,), dtype=torch.int32, device=dev))


def omp_fused(D: torch.Tensor, X: torch.Tensor, *, T: int, eps: float = 0.0,
              eps_mode: bool = False):
    """Fused OMP over the columns of X (p, N) with dictionary D (p, K).
    Returns (idx, gamma, err, nsel)."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return omp_fused_reference(D, X, T=T, eps=eps, eps_mode=eps_mode)
    _check_cuda_call(D, X, T, kernel_supports)
    p, K = D.shape
    N = X.shape[1]
    idx, gamma, err, nsel = _outputs(N, T, X.device)
    if N == 0:
        return idx, gamma, err, nsel
    D = D.contiguous()
    X = X.contiguous()
    G = gram(D, D, symmetric=True)           # (K, K), one launch
    Dt = D.T.contiguous()                    # (K, p): an atom is a row
    lib = _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lyssa_omp_fused(
            X.data_ptr(), D.data_ptr(), Dt.data_ptr(), G.data_ptr(), p, K, N,
            T, float(eps * eps), int(eps_mode), block_lanes(p, K, T),
            idx.data_ptr(), gamma.data_ptr(), err.data_ptr(),
            nsel.data_ptr(), stream)
    _build.check(lib, code, "omp_fused kernel")
    if eps_mode:
        omp_fused.launches_eps += 1
    else:
        omp_fused.launches_t += 1
    return idx, gamma, err, nsel


# kernel launches, one count per mode: fixed T (K1) and error-stopped (K2)
omp_fused.launches_t = 0
omp_fused.launches_eps = 0


# --- the residual form, for K above the Gram form's cap

def residual_lane_smem_bytes(p: int, T: int) -> int:
    """Shared memory one lane (warp) of ``csrc/omp_residual.cu`` holds: its
    x and r (p rounded up to the staging slice each), the T x T factor, six
    T-vectors and its four partial maxima (value and index).  K does not
    enter."""
    return 4 * (2 * _round_up(p, _BP) + T * T + 6 * T + 8)


def residual_block_smem_bytes(p: int, T: int, lanes: int) -> int:
    """Shared memory a block of ``lanes`` lanes of the residual kernel
    takes: theirs and the staging ring of D."""
    return 4 * _STAGE + lanes * residual_lane_smem_bytes(p, T)


def residual_block_lanes(p: int, T: int) -> int:
    """Lanes a block of the residual kernel carries: the most of ``_LANES``
    whose block fits the shared memory a block may have (0: none fits)."""
    return next((n for n in _LANES if residual_block_smem_bytes(p, T, n)
                 <= _build.SMEM_PER_BLOCK), 0)


def residual_kernel_supports(p: int, K: int, T: int) -> bool:
    """Whether the residual kernel takes signals of length p over K atoms
    at T steps: any K, and a block of the fewest lanes fits shared
    memory."""
    return p >= 1 and K >= 1 and T >= 1 and residual_block_lanes(p, T) > 0


def omp_residual_fused(D: torch.Tensor, X: torch.Tensor, *, T: int,
                       eps: float = 0.0, eps_mode: bool = False):
    """Fused OMP in the residual form over the columns of X (p, N) with
    dictionary D (p, K), for any K.  Returns (idx, gamma, err, nsel), as
    ``omp_fused`` does."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return omp_fused_reference(D, X, T=T, eps=eps, eps_mode=eps_mode)
    _check_cuda_call(D, X, T, residual_kernel_supports)
    p, K = D.shape
    N = X.shape[1]
    idx, gamma, err, nsel = _outputs(N, T, X.device)
    if N == 0:
        return idx, gamma, err, nsel
    D = D.contiguous()
    X = X.contiguous()
    Dt = D.T.contiguous()                    # (K, p): an atom is a row
    lib = _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lyssa_omp_residual(
            X.data_ptr(), D.data_ptr(), Dt.data_ptr(), p, K, N, T,
            float(eps * eps), int(eps_mode), residual_block_lanes(p, T),
            idx.data_ptr(), gamma.data_ptr(), err.data_ptr(),
            nsel.data_ptr(), stream)
    _build.check(lib, code, "omp_residual kernel")
    if eps_mode:
        omp_residual_fused.launches_eps += 1
    else:
        omp_residual_fused.launches_t += 1
    return idx, gamma, err, nsel


# kernel launches, one count per mode: fixed T (K1-L) and error-stopped (K2-L)
omp_residual_fused.launches_t = 0
omp_residual_fused.launches_eps = 0
