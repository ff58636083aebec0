"""Label-Consistent K-SVD (Jiang, Lin, Davis 2011) —
``lyssandra_tpu.classify.lc_ksvd`` counterpart.

LC-KSVD2 learns a dictionary D, a code transform A and a linear classifier
W jointly, by K-SVD on the stacked system

    X~ = [X; sqrt(alpha) Q; sqrt(beta) H],
    D~ = [D; sqrt(alpha) A; sqrt(beta) W]   (columns renormalized),

where Q (K, N) holds the label-consistent ideal codes (atoms assigned to
classes in blocks) and H (C, N) the one-hot labels.  The init: per-class
K-SVD dictionaries side by side, Batch-OMP codes over them, A and W by
ridge regression.  Prediction: gamma = OMP(D, x), argmax W gamma.

On a GPU the Batch-OMP codes (ridge init, every stacked K-SVD iteration)
and the predict's OMP run the fused OMP kernel (``ops/cuda_omp.py``); the
per-class init codes by the plain ``_omp_impl``, as the reference does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.classify.linear import _labels_np, one_hot, ridge
from lyssandra_tpu_torch.config import KSVDConfig, LCKSVDConfig
from lyssandra_tpu_torch.dict_learning.ksvd import (
    KSVDLearner,
    ksvd_atom_update,
)
from lyssandra_tpu_torch.ops.dictionaries import (
    init_dictionary,
    normalize_atoms,
)
from lyssandra_tpu_torch.solvers.encoder import SparseEncoder
from lyssandra_tpu_torch.solvers.greedy import _omp_impl


def _ksvd_init_scan(Xs, D0s, *, T: int, n_iter: int):
    """The C per-class K-SVD init fits: ``n_iter`` iterations each of
    plain residual-form OMP coding and a Gauss-Seidel atom sweep, then
    normalization.  Xs (C, p, nmax) zero-padded class signals, D0s
    (C, p, Kc).  The classes run one after another; a zero-padded column
    codes to zero and stays out of every atom update, so the padding
    changes nothing.  Returns Ds (C, p, Kc)."""
    out = []
    for Xc, D in zip(Xs, D0s):
        for _ in range(n_iter):
            Gamma = _omp_impl(D, Xc, 0.0, T=T, eps_mode=False).dense(
                D.shape[1])
            D, _ = ksvd_atom_update(Xc, D, Gamma)
            D = normalize_atoms(D)
        out.append(D)
    return torch.stack(out)


def build_label_consistency(y, K: int, C: int, device=None) -> torch.Tensor:
    """Q (K, N): atom k belongs to class c in contiguous blocks of K // C,
    the remainder atoms to the last class (oracle.build_label_consistency).
    On ``device`` (default: the GPU)."""
    y = np.asarray(y, int)
    per = K // C
    lo = np.minimum(y * per, K)
    hi = np.where(y == C - 1, K, (y + 1) * per)
    ks = np.arange(K)[:, None]
    Q = ((ks >= lo[None, :]) & (ks < hi[None, :])).astype(np.float32)
    return torch.as_tensor(Q, device=resolve_device(device))


def _wait(device: torch.device) -> None:
    """Let the queued device work finish, so a host clock reading covers
    it (timings_)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LCKSVD:
    """fit(X, y) -> self with D_, A_, W_; predict by argmax(W gamma).

    ``device``: where the fit runs (default: where X lies if it is a
    tensor, else the GPU; see ``_device.resolve_device``).  ``timings_``
    holds the seconds of the fit's parts, each read after the device has
    finished it."""

    def __init__(self, cfg: LCKSVDConfig = LCKSVDConfig(), *,
                 predict_T: int | None = None, device=None):
        self.cfg = cfg
        self.predict_T = predict_T if predict_T is not None else cfg.T
        self.device = device

    def fit(self, X, y) -> "LCKSVD":
        cfg = self.cfg
        device = resolve_device(self.device, X)
        X = torch.as_tensor(X, dtype=torch.float32, device=device)
        y = _labels_np(y)
        p, N = X.shape
        C = int(y.max()) + 1
        K = cfg.K
        self.C_ = C
        self.timings_ = {}
        t0 = time.perf_counter()

        # --- init: per-class K-SVD dictionaries, ridge-initialized A, W
        per = K // C
        init_iters = max(2, cfg.n_iter // 2)
        if K % C == 0:
            counts = np.bincount(y, minlength=C)
            nmax = int(counts.max())
            Xs = torch.zeros((C, p, nmax), dtype=torch.float32, device=device)
            for c in range(C):
                cols = torch.from_numpy(np.where(y == c)[0]).to(device)
                Xs[c, :, :counts[c]] = X[:, cols]
            D0s = torch.stack([
                init_dictionary(Xs[c, :, :counts[c]], per, "data",
                                cfg.seed + c)
                for c in range(C)])
            Ds = _ksvd_init_scan(Xs, D0s, T=min(cfg.T, per),
                                 n_iter=init_iters)
            D0 = Ds.permute(1, 0, 2).reshape(p, K)
        else:
            subdicts = []
            for c in range(C):
                Kc = per if c < C - 1 else K - per * (C - 1)
                cols = torch.from_numpy(np.where(y == c)[0]).to(device)
                sub = KSVDLearner(
                    KSVDConfig(K=Kc, T=min(cfg.T, Kc), n_iter=init_iters,
                               init="data", replace_dead=False,
                               seed=cfg.seed + c),
                    device=device).fit(X[:, cols])
                subdicts.append(sub.D_)
            D0 = torch.cat(subdicts, dim=1)
        D0 = normalize_atoms(D0)
        _wait(device)
        self.timings_["init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        enc = SparseEncoder("bomp", {"T": cfg.T}, check_atoms=False,
                            device=device)
        G0 = enc.encode(X, D0)
        Q = build_label_consistency(y, K, C, device)
        H = one_hot(y, C, device)
        A0 = ridge(G0, Q)
        W0 = ridge(G0, H)
        _wait(device)
        self.timings_["ridge_init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # --- stack and run K-SVD on the joint system
        sa, sb = float(np.sqrt(cfg.alpha)), float(np.sqrt(cfg.beta))
        Xt = torch.cat([X, sa * Q, sb * H], dim=0)
        Dt = normalize_atoms(torch.cat([D0, sa * A0, sb * W0], dim=0))
        learner = KSVDLearner(
            KSVDConfig(K=K, T=cfg.T, n_iter=cfg.n_iter, replace_dead=False,
                       seed=cfg.seed),
            device=device).fit(Xt, D0=Dt)
        Dt = learner.D_
        self.history_ = learner.history_
        _wait(device)
        self.timings_["stacked_fit_s"] = time.perf_counter() - t0

        # --- unstack; renormalize so D has unit columns (A, W rescale with)
        D = Dt[:p]
        A = Dt[p:p + K] / sa if sa > 0 else torch.zeros((K, K),
                                                        device=device)
        W = Dt[p + K:] / sb if sb > 0 else torch.zeros((C, K),
                                                       device=device)
        nrm = torch.linalg.vector_norm(D, dim=0, keepdim=True).clamp_min(
            1e-12)
        self.D_ = D / nrm
        self.A_ = A / nrm
        self.W_ = W / nrm
        return self

    def transform(self, X) -> torch.Tensor:
        """Sparse codes of X over the learned D (OMP, predict_T atoms)."""
        enc = SparseEncoder("omp", {"T": self.predict_T}, check_atoms=False,
                            device=self.D_.device)
        return enc.encode(torch.as_tensor(X, dtype=torch.float32,
                                          device=self.D_.device), self.D_)

    def decision_function(self, X) -> torch.Tensor:
        return self.W_ @ self.transform(X)

    def predict(self, X) -> np.ndarray:
        return self.decision_function(X).argmax(dim=0).cpu().numpy()

    def score(self, X, y) -> float:
        return float((self.predict(X) == _labels_np(y)).mean())
