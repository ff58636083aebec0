"""Fused OMP selection: the argmax of |r D| per row without the (N, K)
correlation in memory (``lyssandra_tpu.ops.pallas_select`` counterpart).

``select_abs_argmax`` launches the CUDA kernel ``csrc/select.cu`` for
tensors on the GPU and runs its plain PyTorch version,
``select_abs_argmax_reference`` (the selection ``greedy._omp_impl`` runs
unfused), for tensors on the CPU.  Output: k (N,) int32, the lowest index
among the maxima of |r_n . d_k|.  In float32 the kernel runs on the fma
units; with ``bf16=True`` it rounds both operands to bf16 and sums the
products in float32 on the tensor cores.

The reference's gate (a TPU, N % 512, p % 8, K % 128) does not carry
over: the kernel takes any N, K and any p up to ``MAX_P``.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import _launch
from lyssandra_tpu_torch.solvers.greedy import _argmax_abs

MAX_P = 512
# csrc/select.cu's tiles.  float32: slices of 32 rows of D, two in flight,
# 128 atoms a tile, rows of r transposed with 4 floats of padding.  bf16,
# streaming D: 128 rows of r and 128 atoms a tile, p in chunks of up to 64,
# three in flight, rows of both padded by 8 bf16 values.  bf16 with D
# resident (p up to 64, where all of D fits): 8 warps of 32 rows.
_F32_BP, _F32_STAGES, _BN = 32, 2, 128
_BF16_BM, _BF16_CK, _BF16_STAGES = 128, 64, 3
_RES_WARPS, _RES_GROUP = 8, 64


def select_abs_argmax_reference(r: torch.Tensor, D: torch.Tensor, *,
                                bf16: bool = False) -> torch.Tensor:
    """Plain version of the kernel: ``_argmax_abs(r @ D)``, with both
    operands rounded to bf16 (and the product taken in float32) when
    ``bf16``."""
    if bf16:
        r, D = r.bfloat16().float(), D.bfloat16().float()
    return _argmax_abs(r @ D)


def _padded(p: int, m: int) -> int:
    return -(-p // m) * m


def _resident_bytes(p: int, K: int) -> int:
    ld = _padded(p, 16) + 8
    return 2 * (_padded(K, _RES_GROUP) * ld + _RES_WARPS * 32 * ld)


def resident(p: int, K: int) -> bool:
    """Whether the bf16 mode keeps all of D in shared memory (p up to 64,
    and D with its rows padded fits beside 8 warps' rows of r), rather
    than streaming it in tiles."""
    return (_padded(p, 16) <= 64
            and _resident_bytes(p, K) <= _build.SMEM_PER_BLOCK)


def block_rows(p: int) -> int:
    """Rows of r one block of the float32 kernel takes: 128, or 64 once p
    rounded up to 32 exceeds 256, so that p=512 fits shared memory."""
    return 128 if _padded(p, _F32_BP) <= 256 else 64


def smem_bytes(p: int, K: int, bf16: bool = False) -> int:
    """Shared memory one block of the kernel holds.  float32: its rows of
    r, transposed, p rounded up to 32, rows of ``block_rows + 4`` floats,
    and two 32 x 128 slices of D.  bf16 streaming D: 128 rows of r in bf16,
    p rounded up to 16 plus 8, and three chunks of 128 atoms by min(p, 64)
    plus 8.  bf16 with D resident: K rounded up to 64 atoms and 256 rows of
    r, each p rounded up to 16 plus 8 bf16 values.  The kernel library's
    ``lyssa_select_smem_bytes`` computes the same from the kernel's own
    constants; ``chip_smoke.py`` compares the two."""
    if bf16:
        if resident(p, K):
            return _resident_bytes(p, K)
        pp = _padded(p, 16)
        ck = min(pp, _BF16_CK)
        return 2 * (_BF16_BM * (pp + 8) + _BF16_STAGES * _BN * (ck + 8))
    pp = _padded(p, _F32_BP)
    return 4 * (pp * (block_rows(p) + 4) + _F32_STAGES * _F32_BP * _BN)


def kernel_supports(p: int, K: int) -> bool:
    """Whether the kernel takes signals of length p over K atoms (in both
    modes)."""
    return (1 <= p <= MAX_P and K >= 1
            and max(smem_bytes(p, K), smem_bytes(p, K, True))
            <= _build.SMEM_PER_BLOCK)


def takes(D, X, *, any_device: bool = False) -> bool:
    """Whether ``select_abs_argmax`` launches its kernel for the rows of
    X^T, X (p, N), over D (p, K): a float32 pair on the GPU whose p and K
    the kernel supports.  ``any_device`` leaves the device out, for a
    caller that also sends such a pair on the CPU to the wrapper, where its
    plain version runs."""
    on_gpu = any_device or (D.is_cuda and X.is_cuda)
    return (_launch.kernel_types("cuda" if on_gpu else "cpu", D.dtype,
                                 X.dtype)
            and kernel_supports(D.shape[0], D.shape[1]))


def select_abs_argmax(r: torch.Tensor, D: torch.Tensor, *,
                      bf16: bool = False) -> torch.Tensor:
    """k_n = argmax_k |r_n . d_k| (lowest index on ties) for r (N, p) and
    D (p, K); bf16 rounds both operands to bf16 and sums in float32."""
    if r.device.type == "cpu" and D.device.type == "cpu":
        return select_abs_argmax_reference(r, D, bf16=bf16)
    # X = r^T, as the predicate reads the pair
    _launch.check_pair(D, r.T if r.ndim == 2 else r, takes,
                       f"1 <= p <= {MAX_P} and K >= 1")
    N, p = r.shape
    K = D.shape[1]
    k = torch.empty((N,), dtype=torch.int32, device=r.device)
    if N == 0:
        return k
    r = r.contiguous()
    D = D.contiguous()
    # D^T rounded to bf16, p zero-filled to a multiple of 16
    Dh = (torch.empty((K * _padded(p, 16),), dtype=torch.bfloat16,
                      device=r.device) if bf16 else None)
    _launch.launch(
        "select_abs_argmax", "lyssa_select_abs_argmax", r.data_ptr(),
        D.data_ptr(), p, K, N, int(bool(bf16)),
        None if Dh is None else Dh.data_ptr(), k.data_ptr(), like=r)
    return k
