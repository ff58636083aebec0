"""Fused OMP selection: the argmax of |r D| per row without the (N, K)
correlation in memory (``lyssandra_tpu.ops.pallas_select`` counterpart).

``select_abs_argmax`` launches the CUDA kernel ``csrc/select.cu`` for
tensors on the GPU and runs its plain PyTorch version,
``select_abs_argmax_reference`` (the selection ``greedy._omp_impl`` runs
unfused), for tensors on the CPU.  Output: k (N,) int32, the lowest index
among the maxima of |r_n . d_k|.

The reference's gate (a TPU, N % 512, p % 8, K % 128) does not carry
over: the kernel takes any N, K and any p up to ``MAX_P``.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.solvers.greedy import _argmax_abs

MAX_P = 512
_BM, _BN, _BP = 64, 64, 16      # csrc/select.cu's tile sizes


def select_abs_argmax_reference(r: torch.Tensor, D: torch.Tensor, *,
                                bf16: bool = False) -> torch.Tensor:
    """Plain version of the kernel: ``_argmax_abs(r @ D)``, with both
    operands rounded to bf16 (and the product taken in float32) when
    ``bf16``."""
    if bf16:
        r, D = r.bfloat16().float(), D.bfloat16().float()
    return _argmax_abs(r @ D)


def smem_bytes(p: int) -> int:
    """Shared memory one block of the kernel holds: its 64 rows of r
    (transposed, p padded to 16, rows of 68 floats) and one 16 x 64 tile
    of D.  The kernel library's ``lyssa_select_smem_bytes`` computes the
    same from the kernel's own constants; ``chip_smoke.py`` compares the
    two."""
    pp = -(-p // _BP) * _BP
    return 4 * (pp * (_BM + 4) + _BP * _BN)


def kernel_supports(p: int, K: int) -> bool:
    """Whether the kernel takes signals of length p over K atoms."""
    return (1 <= p <= MAX_P and K >= 1
            and smem_bytes(p) <= _build.SMEM_PER_BLOCK)


def select_abs_argmax(r: torch.Tensor, D: torch.Tensor, *,
                      bf16: bool = False) -> torch.Tensor:
    """k_n = argmax_k |r_n . d_k| (lowest index on ties) for r (N, p) and
    D (p, K); bf16 rounds both operands to bf16 and sums in float32."""
    if r.device.type == "cpu" and D.device.type == "cpu":
        return select_abs_argmax_reference(r, D, bf16=bf16)
    if not (r.is_cuda and D.is_cuda and r.device == D.device):
        raise ValueError(
            f"no kernel for r on {r.device} and D on {D.device}")
    if r.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError(f"kernel takes float32, got {r.dtype}, {D.dtype}")
    if r.ndim != 2 or D.ndim != 2 or r.shape[1] != D.shape[0]:
        raise ValueError(
            f"r (N, p) and D (p, K) expected, got {tuple(r.shape)} and "
            f"{tuple(D.shape)}")
    N, p = r.shape
    K = D.shape[1]
    if not kernel_supports(p, K):
        raise ValueError(
            f"kernel takes 1 <= p <= {MAX_P} and K >= 1; got p={p}, K={K}")
    k = torch.empty((N,), dtype=torch.int32, device=r.device)
    if N == 0:
        return k
    r = r.contiguous()
    D = D.contiguous()
    lib = _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lyssa_select_abs_argmax(
            r.data_ptr(), D.data_ptr(), p, K, N, int(bool(bf16)),
            k.data_ptr(), stream)
    _build.check(lib, code, "select_abs_argmax kernel")
    select_abs_argmax.launches += 1
    return k


# kernel launches (K7)
select_abs_argmax.launches = 0
