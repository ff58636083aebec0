"""Linear classification on sparse codes (``lyssandra_tpu.classify.linear``
counterpart): ridge regression to one-hot targets, and a one-vs-rest
squared-hinge linear SVM.  Every class is a row of W and every sample a
column, so no Python loop runs over classes or samples."""

from __future__ import annotations

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device


def _labels(y, device) -> torch.Tensor:
    if isinstance(y, torch.Tensor):
        return y.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(y), dtype=torch.int64, device=device)


def _labels_np(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        y = y.cpu().numpy()
    return np.asarray(y, int)


def one_hot(y, C: int, device=None) -> torch.Tensor:
    """(C, N) float32 one-hot label matrix (oracle.one_hot layout), on
    ``device`` (default: where y lies if it is a tensor, else the GPU)."""
    y = _labels(y, resolve_device(device, y))
    return torch.nn.functional.one_hot(y, C).to(torch.float32).T


def ridge(Z, Y, lam: float = 1.0) -> torch.Tensor:
    """W = Y Z^T (Z Z^T + lam I)^{-1} (oracle.ridge): codes Z (K, N) ->
    targets Y (C, N), float32.  The Gram and the solve run in float64, as
    the oracle's do: with more features than samples and a small lam the
    float32 normal equations lose the answer (config 6's 1,280 pooled
    features of 240 images at lam=1e-2 classify at 0.4167 in float32 and
    0.9750 in float64: chip_smoke.py path (p) on an H100)."""
    device = resolve_device(None, Z, Y)
    Z = torch.as_tensor(Z, device=device).to(torch.float64)
    Y = torch.as_tensor(Y, device=device).to(torch.float64)
    K = Z.shape[0]
    gram = Z @ Z.T + lam * torch.eye(K, dtype=Z.dtype, device=device)
    return torch.linalg.solve(gram, Z @ Y.T).T.to(torch.float32)


def _with_intercept(Z):
    return torch.cat([Z, torch.ones((1, Z.shape[1]), dtype=Z.dtype,
                                    device=Z.device)], dim=0)


class LinearSVM:
    """Multiclass linear SVM on (sparse) code vectors: one-vs-rest squared
    hinge, minimized by ``n_iter`` full-batch Nesterov steps with the step
    1 / (2 ||Z||_F^2 / N + 1 / (C N)) unless ``lr`` is given.  ``device``:
    where it fits (default: where Z lies, else the GPU)."""

    def __init__(self, C: float = 1.0, n_iter: int = 300,
                 lr: float | None = None, fit_intercept: bool = True, *,
                 device=None):
        self.C = C
        self.n_iter = n_iter
        self.lr = lr
        self.fit_intercept = fit_intercept
        self.device = device

    def _codes(self, Z, device):
        Z = torch.as_tensor(Z, dtype=torch.float32, device=device)
        return _with_intercept(Z) if self.fit_intercept else Z

    def fit(self, Z, y) -> "LinearSVM":
        device = resolve_device(self.device, Z, y)
        Z = self._codes(Z, device)                     # (F, N)
        y = _labels(y, device)
        F, N = Z.shape
        C_cls = int(y.max()) + 1
        self.classes_ = C_cls
        Ypm = 2.0 * one_hot(y, C_cls) - 1.0            # (C, N) in {-1, +1}
        lam = 1.0 / (self.C * N)
        # the gradient's Lipschitz bound: 2/N ||Z||^2 + lam
        znorm = float(torch.linalg.norm(Z) ** 2)
        lr = self.lr if self.lr is not None else 1.0 / (2.0 * znorm / N
                                                        + lam)

        def grad(W):
            M = (1.0 - Ypm * (W @ Z)).clamp_min(0.0)   # (C, N) margins
            return (-2.0 / N) * ((Ypm * M) @ Z.T) + lam * W

        # the momentum scalar in float32, as the reference carries it
        one, half, four = np.float32(1.0), np.float32(0.5), np.float32(4.0)
        W = torch.zeros((C_cls, F), dtype=torch.float32, device=device)
        V, t = W, one
        for _ in range(self.n_iter):
            Wn = V - lr * grad(V)
            tn = half * (one + np.sqrt(one + four * t * t))
            V = Wn + ((t - one) / tn) * (Wn - W)
            W, t = Wn, tn
        self.W_ = W
        return self

    def decision_function(self, Z) -> torch.Tensor:
        return self.W_ @ self._codes(Z, self.W_.device)

    def predict(self, Z) -> torch.Tensor:
        return self.decision_function(Z).argmax(dim=0)

    def score(self, Z, y) -> float:
        pred = self.predict(Z)
        return float((pred == _labels(y, pred.device)).double().mean())


class LinearClassifier:
    """Ridge-to-one-hot linear classifier on (sparse) code vectors."""

    def __init__(self, lam: float = 1.0, *, device=None):
        self.lam = lam
        self.device = device

    def fit(self, Z, y) -> "LinearClassifier":
        device = resolve_device(self.device, Z, y)
        y = _labels(y, device)
        self.classes_ = int(y.max()) + 1
        self.W_ = ridge(torch.as_tensor(Z, dtype=torch.float32,
                                        device=device),
                        one_hot(y, self.classes_), self.lam)
        return self

    def decision_function(self, Z) -> torch.Tensor:
        return self.W_ @ torch.as_tensor(Z, dtype=torch.float32,
                                         device=self.W_.device)

    def predict(self, Z) -> torch.Tensor:
        return self.decision_function(Z).argmax(dim=0)

    def score(self, Z, y) -> float:
        pred = self.predict(Z)
        return float((pred == _labels(y, pred.device)).double().mean())
