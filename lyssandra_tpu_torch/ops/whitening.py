"""PCA / ZCA whitening (``lyssandra_tpu.ops.whitening`` counterpart).

fit: eigendecomposition of the patch covariance on the device
(``torch.linalg.eigh``); transform and inverse are single products.  ZCA:
W = V (Lam + eps I)^{-1/2} V^T; PCA-whitening keeps the ``pca_dim``
leading components.  ``fused_params`` feeds the whitening epilogue of the
fused patch kernel (``ops/cuda_patches.fused_patch_pipeline(whiten=)``).
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.config import WhitenConfig


class Whitener:
    """fit(X) -> self; transform / inverse_transform on (p, N) columns.
    ``fit`` runs on ``device`` (default: where X lies if it is a tensor,
    else the GPU); later inputs go to the fitted device."""

    def __init__(self, cfg: WhitenConfig = WhitenConfig(), *, device=None):
        self.cfg = cfg
        self.device = device

    def _on(self, X) -> torch.Tensor:
        return torch.as_tensor(X, dtype=torch.float32,
                               device=self.mean_.device)

    def fit(self, X) -> "Whitener":
        device = resolve_device(self.device, X)
        X = torch.as_tensor(X, dtype=torch.float32, device=device)
        self.mean_ = X.mean(dim=1, keepdim=True)
        Xc = X - self.mean_
        C = (Xc @ Xc.T) / X.shape[1]
        lam, V = torch.linalg.eigh(C)         # ascending
        lam = lam.flip(0)
        V = V.flip(1)
        if self.cfg.pca_dim is not None:
            lam = lam[: self.cfg.pca_dim]
            V = V[:, : self.cfg.pca_dim]
        d = 1.0 / torch.sqrt(lam + self.cfg.eps)
        if self.cfg.pca_dim is None:
            self.W_ = (V * d[None, :]) @ V.T            # ZCA
            self.Winv_ = (V / d[None, :]) @ V.T
        else:
            self.W_ = (V * d[None, :]).T                # PCA-whiten
            self.Winv_ = V / d[None, :]
        return self

    def transform(self, X) -> torch.Tensor:
        return self.W_ @ (self._on(X) - self.mean_)

    def inverse_transform(self, Xw) -> torch.Tensor:
        return self.Winv_ @ self._on(Xw) + self.mean_

    def fused_params(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(W, W @ mean), the ``whiten=`` argument of
        ``fused_patch_pipeline``: the kernel computes W x - W m =
        transform(x) in the same pass as extraction, DC removal and
        contrast normalization."""
        return self.W_, (self.W_ @ self.mean_).reshape(-1)


ZCAWhitener = Whitener
