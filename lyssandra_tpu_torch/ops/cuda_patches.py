"""Fused patch pipeline: extract + DC removal + contrast normalization +
whitening in one pass (``lyssandra_tpu.ops.pallas_patches`` counterpart).

``fused_patch_pipeline_p1`` launches the CUDA kernel
``csrc/fused_patches.cu`` for an image on the GPU and runs its plain
PyTorch version, ``fused_patch_pipeline_reference``, for an image on the
CPU.  ``fused_patch_pipeline`` takes the kernel for stride-1 grey images
on the GPU and the plain ops otherwise, as the reference does.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import _launch
from lyssandra_tpu_torch.ops.patches import extract_patches


def fused_patch_pipeline_reference(
    img: torch.Tensor, p: int, stride: int = 1, *, do_dc: bool = True,
    do_norm: bool = False,
    whiten: tuple[torch.Tensor, torch.Tensor] | None = None,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (X (p^2, N), means (N,), scales (N,)).  The patch
    mean and the sum of squares are accumulated in float64 and rounded once
    to float32, as the kernel does, so the two agree to the last bit or
    so whatever their summation order."""
    X = extract_patches(img, p, stride)
    means = X.mean(dim=0, dtype=torch.float64).to(torch.float32)
    if do_dc:
        X = X - means[None, :]
    scales = (X.to(torch.float64) ** 2).sum(dim=0).sqrt().to(
        torch.float32).clamp_min(eps)
    if do_norm:
        X = X / scales[None, :]
    if whiten is not None:
        Wm, off = whiten
        X = torch.matmul(Wm.to(X), X) - off.to(X)[:, None]
    return X, means, scales


def fused_patch_pipeline_p1(
    img: torch.Tensor, p: int, *, do_dc: bool = True, do_norm: bool = False,
    whiten: tuple[torch.Tensor, torch.Tensor] | None = None,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stride-1 fused pipeline on a grey (H, W) image.  Returns (X (p^2,
    Np), means (Np,), scales (Np,)).  whiten: optional (Wm (p^2, p^2),
    offset (p^2,)) applied as X <- Wm X - offset[:, None]."""
    if img.device.type == "cpu":
        return fused_patch_pipeline_reference(
            img, p, do_dc=do_dc, do_norm=do_norm, whiten=whiten, eps=eps)
    if not img.is_cuda:
        raise ValueError(f"no kernel for device {img.device}")
    if img.ndim != 2 or img.dtype != torch.float32:
        raise ValueError(
            f"kernel takes a float32 (H, W) image, got {img.dtype} "
            f"{tuple(img.shape)}")
    H, W = img.shape
    if not 1 <= p <= min(H, W):
        raise ValueError(f"patch size {p} does not fit a {H}x{W} image")
    img = img.contiguous()
    p2 = p * p
    Np = (H - p + 1) * (W - p + 1)
    wm_ptr = off_ptr = None
    if whiten is not None:
        Wm, off = (t.to(device=img.device, dtype=torch.float32).contiguous()
                   for t in whiten)
        if Wm.shape != (p2, p2) or off.shape != (p2,):
            raise ValueError(
                f"kernel whitening takes Wm ({p2}, {p2}) and offset "
                f"({p2},), got {tuple(Wm.shape)} and {tuple(off.shape)}")
        if (_build.load().lyssa_fused_patches_whiten_smem(p)
                > _build.SMEM_PER_BLOCK):
            raise ValueError(f"whitening at p={p} exceeds shared memory")
        wm_ptr, off_ptr = Wm.data_ptr(), off.data_ptr()
    X = torch.empty((p2, Np), dtype=torch.float32, device=img.device)
    means = torch.empty((Np,), dtype=torch.float32, device=img.device)
    scales = torch.empty((Np,), dtype=torch.float32, device=img.device)
    _launch.launch(
        "fused_patches", "lyssa_fused_patches", img.data_ptr(), H, W, p,
        int(do_dc), int(do_norm), float(eps), wm_ptr, off_ptr, X.data_ptr(),
        means.data_ptr(), scales.data_ptr(), like=img)
    return X, means, scales



def fused_patch_pipeline(
    img: torch.Tensor, p: int, stride: int = 1, *, do_dc: bool = True,
    do_norm: bool = False,
    whiten: tuple[torch.Tensor, torch.Tensor] | None = None,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """extract + (DC removal) + (contrast normalization) + (whitening):
    the fused kernel for a stride-1 grey image on the GPU, the plain ops
    for other strides, colour images and the CPU."""
    if img.is_cuda and stride == 1 and img.ndim == 2:
        return fused_patch_pipeline_p1(
            img, p, do_dc=do_dc, do_norm=do_norm, whiten=whiten, eps=eps)
    return fused_patch_pipeline_reference(
        img, p, stride, do_dc=do_dc, do_norm=do_norm, whiten=whiten,
        eps=eps)
