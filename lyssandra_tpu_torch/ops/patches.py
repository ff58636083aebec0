"""Patch pipeline ops: unfold / fold / DC removal / contrast normalization.

Counterpart of ``lyssandra_tpu.ops.patches`` with the same layout: patches
are the columns of ``X (p^2, N)``, row-major over positions and row-major
within a patch; a colour image (H, W, C) gives ``(C p^2, N)`` with the
channels stacked as leading row blocks.  ``F.unfold`` orders its rows as
(channel, kernel row, kernel column), which is exactly that layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def n_patches(H: int, W: int, p: int, stride: int = 1) -> tuple[int, int]:
    """Number of patch positions (rows, cols)."""
    return (H - p) // stride + 1, (W - p) // stride + 1


def _nchw(img: torch.Tensor) -> torch.Tensor:
    """(H, W) or (H, W, C) image -> (1, C, H, W) float32."""
    img = img.to(torch.float32)
    if img.ndim == 3:
        return img.permute(2, 0, 1)[None]
    return img[None, None]


def extract_patches(img: torch.Tensor, p: int,
                    stride: int = 1) -> torch.Tensor:
    """All p x p patches at the given stride, as columns of X."""
    return F.unfold(_nchw(img), p, stride=stride)[0]


def fold_patches(X: torch.Tensor, shape: tuple, p: int,
                 stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Overlap-add: returns (sum image, count image); a 3-tuple shape
    (H, W, C) folds the C channel row-blocks of X (count (H, W, 1))."""
    H, W = shape[:2]
    acc = F.fold(X[None], (H, W), p, stride=stride)[0]      # (C, H, W)
    ones = torch.ones((1, p * p, X.shape[1]), dtype=X.dtype,
                      device=X.device)
    cnt = F.fold(ones, (H, W), p, stride=stride)[0]         # (1, H, W)
    if len(shape) == 3:
        return acc.permute(1, 2, 0), cnt.permute(1, 2, 0)
    return acc[0], cnt[0]


def reconstruct_from_patches(X: torch.Tensor, shape: tuple, p: int,
                             stride: int = 1) -> torch.Tensor:
    """Plain overlap-add average (inverse of extract_patches)."""
    acc, cnt = fold_patches(X, shape, p, stride)
    return acc / cnt.clamp_min(1.0)


def weighted_reconstruct(X: torch.Tensor, y: torch.Tensor, p: int,
                         lam: float, stride: int = 1) -> torch.Tensor:
    """Elad-Aharon denoising blend ``(lam*y + sum R^T x_hat) / (lam +
    counts)`` (grayscale or colour y)."""
    acc, cnt = fold_patches(X, tuple(y.shape), p, stride)
    return (lam * y + acc) / (lam + cnt)


def remove_dc(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Subtract the per-column (per-patch) mean; return (centered, means)."""
    means = X.mean(dim=0)
    return X - means[None, :], means


def contrast_normalize(X: torch.Tensor,
                       eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Divide each column by max(||x||_2, eps); return (normalized, scales)."""
    scales = torch.linalg.vector_norm(X, dim=0).clamp_min(eps)
    return X / scales[None, :], scales
