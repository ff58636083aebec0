"""Product kernel C = A^T B (``csrc/gram.cu``): alpha0 = X^T D and the Gram
matrix G = D^T D that the Gram-form kernels (``cuda_fs.fs_cold_fused``,
``cuda_group.group_omp_fused``) start from.  The TPU kernels compute D^T x
in their own bodies (``lyssandra_tpu/ops/pallas_fs.py::_kernel_fs_cold``,
``pallas_group.py::_kernel``, ``::_kernel_packed``), so this product is part
of their port.

``gram`` launches the kernel for tensors on the GPU and runs its plain
PyTorch version, ``gram_reference`` (``A.T @ B``), for tensors on the CPU.
Both take row-major float32 A (p, M) and B (p, K), any p >= 1, and return
C (M, K) float32 in full float32 precision (no TF32).  ``symmetric=True``
asks for the Gram matrix A^T A (B must be A): the kernel then computes
only the tiles on or above the diagonal and mirrors them, bitwise equal to
the full product.  The Gram-form OMP kernels (``cuda_omp.omp_fused``) take
their G = D^T D from it too.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch.ops import _launch


def gram_reference(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``A.T @ B``."""
    return A.T @ B


def gram(A: torch.Tensor, B: torch.Tensor, *,
         symmetric: bool = False) -> torch.Tensor:
    """C = A^T B for A (p, M) and B (p, K); ``symmetric=True`` (B is A)
    computes one triangle of A^T A and mirrors it."""
    if symmetric and B is not A:
        raise ValueError("symmetric=True computes A^T A: pass B = A")
    if A.ndim != 2 or B.ndim != 2 or A.shape[0] != B.shape[0]:
        raise ValueError(
            f"A (p, M) and B (p, K) expected, got {tuple(A.shape)} and "
            f"{tuple(B.shape)}")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise ValueError(f"gram takes float32, got {A.dtype}, {B.dtype}")
    p, M = A.shape
    K = B.shape[1]
    if p < 1:
        raise ValueError(f"gram takes p >= 1, got p={p}")
    if A.device.type == "cpu" and B.device.type == "cpu":
        return gram_reference(A, B)
    if not (A.is_cuda and B.is_cuda and A.device == B.device):
        raise ValueError(f"no kernel for A on {A.device} and B on {B.device}")
    C = torch.empty((M, K), dtype=torch.float32, device=A.device)
    if M == 0 or K == 0:
        return C
    A = A.contiguous()
    B = A if symmetric else B.contiguous()
    _launch.launch("gram", "lyssa_gram", A.data_ptr(), B.data_ptr(), p, M,
                   K, int(symmetric), C.data_ptr(), like=A)
    return C
