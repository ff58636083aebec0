"""Sparse-representation image inpainting (``lyssandra_tpu.apps.inpaint``
counterpart): code each patch over its observed pixels with masked OMP,
predict the missing ones from the sparse model, and overlap-add the full
reconstructions.  All patches and their masks go through one masked-OMP
call.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.ops.patches import extract_patches, fold_patches
from lyssandra_tpu_torch.solvers.greedy import masked_omp


def inpaint(img, mask, D, *, T: int = 8, eps: float | None = None,
            patch: int = 8, keep_known: bool = True,
            device=None) -> torch.Tensor:
    """Fill the unobserved pixels (mask == 0) of img.

    img:  (H, W) with arbitrary values at the missing pixels.
    mask: (H, W) 1 = observed, 0 = missing.
    D:    (p^2, K) unit-norm dictionary over p x p patches.
    Inputs go to ``device`` (default: where the first tensor input lies,
    else the GPU).
    """
    device = resolve_device(device, img, mask, D)
    img = torch.as_tensor(img, dtype=torch.float32, device=device)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
    D = torch.as_tensor(D, dtype=torch.float32, device=device)
    p = patch
    X = extract_patches(img * mask, p)              # (p^2, N)
    Mp = extract_patches(mask, p)                   # per-patch masks
    # DC over the observed pixels only
    mean = (X * Mp).sum(dim=0) / Mp.sum(dim=0).clamp_min(1.0)
    Xc = (X - mean[None, :]) * Mp
    Gamma = masked_omp(D, Xc, Mp, T, eps)
    Xhat = D @ Gamma + mean[None, :]                # full-patch prediction
    acc, n = fold_patches(Xhat, tuple(img.shape), p)
    out = acc / n.clamp_min(1.0)
    if keep_known:
        out = torch.where(mask > 0, img, out)
    return out
