"""Sparse-representation classification (Wright et al. 2009) —
``lyssandra_tpu.classify.src`` counterpart.  The dictionary is the
training samples; a test sample is coded over it and given the class with
the smallest class-restricted residual ||x - D delta_c(gamma)||_2.

All test samples are coded in one encoder call (``omp``: on a GPU a
fused OMP kernel of ``ops/cuda_omp.py``, with K = the training-set size:
the Gram form up to its cap on K, the residual form above it), and the C
class residuals are C masked reconstructions.
"""

from __future__ import annotations

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.classify.linear import _labels_np
from lyssandra_tpu_torch.ops.dictionaries import normalize_atoms
from lyssandra_tpu_torch.solvers.encoder import SparseEncoder


class SRCClassifier:
    """fit(X, y) stores the normalized training samples as the dictionary;
    predict(X) codes with OMP (or any encoder) and picks the class of the
    smallest residual.  ``device``: where it runs (default: where X lies
    if it is a tensor, else the GPU)."""

    def __init__(self, T: int = 10, *, encoder: SparseEncoder | None = None,
                 normalize: bool = True, device=None):
        self.T = T
        self.device = device
        self.encoder = encoder or SparseEncoder(
            "omp", {"T": T}, check_atoms=False, device=device)
        self.normalize = normalize

    def _set_dictionary(self, D: torch.Tensor, y) -> "SRCClassifier":
        self.D_ = D
        self.y_ = np.asarray(y)
        self.classes_ = np.unique(self.y_)
        # (C, K) class-membership masks over the dictionary's columns
        self.masks_ = torch.as_tensor(
            np.stack([self.y_ == c for c in self.classes_]).astype(
                np.float32), device=D.device)
        return self

    def fit(self, X, y) -> "SRCClassifier":
        X = torch.as_tensor(X, dtype=torch.float32,
                            device=resolve_device(self.device, X))
        return self._set_dictionary(normalize_atoms(X) if self.normalize
                                    else X, _labels_np(y))

    def residuals(self, X) -> torch.Tensor:
        """(C, N) squared class-restricted residual norms."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.D_.device)
        if self.normalize:
            X = normalize_atoms(X)
        Gamma = self.encoder.encode(X, self.D_)             # (K, N)
        res = []
        for c in range(self.masks_.shape[0]):
            R = X - self.D_ @ (Gamma * self.masks_[c][:, None])
            res.append((R * R).sum(dim=0))
        return torch.stack(res)

    def predict(self, X) -> np.ndarray:
        return self.classes_[self.residuals(X).argmin(dim=0).cpu().numpy()]

    def score(self, X, y) -> float:
        return float((self.predict(X) == _labels_np(y)).mean())
