"""Batched greedy sparse solvers: OMP and Batch-OMP
(``lyssandra_tpu.solvers.greedy`` counterpart, main-path subset).

All N signals advance in lock-step as lanes of batched (N, ...) tensors.
Data-dependent stopping (error-constrained mode, dependent-atom breakdown)
freezes a lane through a ``done`` mask: a frozen lane keeps its state.

The progressive Cholesky factor is kept as its inverse ``Linv = L^{-1}``,
one row appended per step:

    L_t = [[L, 0], [w^T, l]]  =>  Linv_t = [[Linv, 0], [-l w^T Linv, l]],
    w = Linv g,  l = 1/sqrt(1 - ||w||^2),  g = G[I, k_new],

so every per-step solve is two batched (N, T, T) x (N, T) products.
Semantics match ``oracle.batch_omp`` / ``oracle.omp`` per signal.

On a GPU, ``batch_omp`` and ``omp`` run the fused CUDA kernel
(``ops/cuda_omp.py``) whenever it takes the shape; elsewhere they run the
batched PyTorch forms below.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class GreedyResult(NamedTuple):
    """Compact result of a batched greedy pursuit.

    idx:   (N, T) int32 — selected atom per step (0-padded after stop).
    gamma: (N, T) f32   — coefficients for idx (0 after stop).
    err:   (N,)   f32   — final squared residual norm estimate.
    nsel:  (N,)   int32 — number of atoms actually selected.
    """

    idx: torch.Tensor
    gamma: torch.Tensor
    err: torch.Tensor
    nsel: torch.Tensor

    def dense(self, K: int) -> torch.Tensor:
        """Dense code matrix Gamma in R^{K x N} (oracle layout)."""
        N, T = self.idx.shape
        valid = torch.arange(T, device=self.idx.device)[None, :] \
            < self.nsel[:, None]
        C = torch.zeros((N, K), dtype=self.gamma.dtype,
                        device=self.gamma.device)
        C.scatter_add_(1, self.idx.long(),
                       torch.where(valid, self.gamma, 0.0))
        return C.T

    def to_csc(self, K: int):
        """scipy.sparse CSC matrix (K, N), without a dense (K, N) array."""
        from scipy import sparse

        idx = self.idx.cpu().numpy()
        gamma = self.gamma.cpu().numpy()
        N, T = idx.shape
        valid = (np.arange(T)[None, :]
                 < self.nsel.cpu().numpy()[:, None]).ravel()
        cols = np.repeat(np.arange(N), T)[valid]
        M = sparse.csc_matrix(
            (gamma.ravel()[valid], (idx.ravel()[valid], cols)), shape=(K, N))
        M.eliminate_zeros()
        return M

    @staticmethod
    def concatenate(results: "list[GreedyResult]") -> "GreedyResult":
        """Stack per-block results along the signal axis."""
        return GreedyResult(*(
            torch.cat([getattr(r, f) for r in results], dim=0)
            for f in GreedyResult._fields
        ))


def _append_cholesky_inv(Linv: torch.Tensor, g: torch.Tensor, t: int):
    """Append row t to the inverse factor.

    Linv: (N, T, T) with rows >= t zero; g: (N, T) = G[I, k_new] (entries
    >= t are ignored because Linv's columns there are zero).  Returns
    (Linv', nu) where nu = 1 - ||w||^2 (breakdown indicator).
    """
    w = torch.einsum("ntj,nj->nt", Linv, g)
    nu = 1.0 - (w * w).sum(dim=-1)
    linv = torch.rsqrt(nu.clamp_min(1e-12))
    newrow = -linv[:, None] * torch.einsum("nt,ntj->nj", w, Linv)
    newrow[:, t] = linv
    Linv = Linv.clone()
    Linv[:, t, :] = newrow
    return Linv, nu


def _solve_gamma(Linv: torch.Tensor, a0sel: torch.Tensor) -> torch.Tensor:
    """gamma = (L L^T)^{-1} a0_I = Linv^T (Linv a0_I), batched."""
    y = torch.einsum("ntj,nj->nt", Linv, a0sel)
    return torch.einsum("njt,nj->nt", Linv, y)


def _argmax_abs(A: torch.Tensor) -> torch.Tensor:
    """First index of the max |A[n, :]| per row (np.argmax tie rule)."""
    s = A.abs()
    mx = s.amax(dim=1, keepdim=True)
    return (s == mx).to(torch.uint8).argmax(dim=1).to(torch.int32)


def _freeze(frozen: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    return torch.where(frozen.reshape((-1,) + (1,) * (new.ndim - 1)),
                       old, new)


def _batch_omp_impl(G, Dt, A0, xnormsq, eps, *, T, eps_mode):
    """Gram form (Rubinstein's Batch-OMP): alpha = alpha0 - Gamma G.

    No selected-atom mask: re-selecting an atom means the residual
    correlation is fp noise; the progressive Cholesky then breaks down
    (nu ~ 0) and the lane freezes — the oracle's ``if k in I: break``.
    """
    N, K = A0.shape
    p = Dt.shape[1]
    dev, dt = A0.device, A0.dtype
    C = torch.zeros((N, K), dtype=dt, device=dev)
    Dsel = torch.zeros((N, T, p), dtype=dt, device=dev)
    Linv = torch.zeros((N, T, T), dtype=dt, device=dev)
    idx = torch.zeros((N, T), dtype=torch.int32, device=dev)
    a0sel = torch.zeros((N, T), dtype=dt, device=dev)
    gamma = torch.zeros((N, T), dtype=dt, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    err = xnormsq.clone()
    nsel = torch.zeros((N,), dtype=torch.int32, device=dev)
    rows = torch.arange(N, device=dev)
    for t in range(T):
        stop = done | (err <= eps * eps) if eps_mode else done
        k = _argmax_abs(A0 - C @ G)
        dk = Dt[k.long()]                                    # (N, p)
        g = torch.einsum("ntp,np->nt", Dsel, dk)
        Linv_n, nu = _append_cholesky_inv(Linv, g, t)
        bad = nu <= 1e-6
        Dsel_n = Dsel.clone()
        Dsel_n[:, t] = dk
        idx_n = idx.clone()
        idx_n[:, t] = k
        a0sel_n = a0sel.clone()
        a0sel_n[:, t] = A0[rows, k.long()]
        gamma_n = _solve_gamma(Linv_n, a0sel_n)
        C_n = torch.zeros_like(C)
        C_n.scatter_add_(1, idx_n.long(), gamma_n)
        err_n = xnormsq - (gamma_n * a0sel_n).sum(dim=1)
        frozen = stop | bad
        C = _freeze(frozen, C_n, C)
        Dsel = _freeze(frozen, Dsel_n, Dsel)
        Linv = _freeze(frozen, Linv_n, Linv)
        idx = _freeze(frozen, idx_n, idx)
        a0sel = _freeze(frozen, a0sel_n, a0sel)
        err = _freeze(frozen, err_n, err)
        gamma = _freeze(frozen, gamma_n, gamma)
        nsel = torch.where(frozen, nsel, nsel + 1)
        done = frozen
    valid = torch.arange(T, device=dev)[None, :] < nsel[:, None]
    return GreedyResult(idx, torch.where(valid, gamma, 0.0), err, nsel)


def _omp_impl(D, X, eps, *, T, eps_mode):
    """Explicit-residual OMP (oracle.omp): correlations from
    r = x - D_I gamma.  In eps mode a lane is done once its residual
    reaches the target, and the whole loop ends once every lane is done
    (one host sync per step)."""
    p, K = D.shape
    N = X.shape[1]
    dev, dt = D.device, D.dtype
    Xt = X.T                                   # (N, p)
    Dt = D.T
    xnormsq = (Xt * Xt).sum(dim=1)
    r = Xt
    Dsel = torch.zeros((N, T, p), dtype=dt, device=dev)
    Linv = torch.zeros((N, T, T), dtype=dt, device=dev)
    idx = torch.zeros((N, T), dtype=torch.int32, device=dev)
    a0sel = torch.zeros((N, T), dtype=dt, device=dev)
    err = xnormsq
    nsel = torch.zeros((N,), dtype=torch.int32, device=dev)
    done = xnormsq <= eps * eps if eps_mode else \
        torch.zeros((N,), dtype=torch.bool, device=dev)
    for t in range(T):
        if eps_mode and bool(done.all()):
            break
        k = _argmax_abs(r @ D)
        dk = Dt[k.long()]                                    # (N, p)
        g = torch.einsum("ntp,np->nt", Dsel, dk)
        Linv_n, nu = _append_cholesky_inv(Linv, g, t)
        bad = nu <= 1e-6
        Dsel_n = Dsel.clone()
        Dsel_n[:, t] = dk
        idx_n = idx.clone()
        idx_n[:, t] = k
        a0sel_n = a0sel.clone()
        a0sel_n[:, t] = (dk * Xt).sum(dim=1)
        gamma = _solve_gamma(Linv_n, a0sel_n)
        r_n = Xt - torch.einsum("nt,ntp->np", gamma, Dsel_n)
        err_n = (r_n * r_n).sum(dim=1)
        frozen = done | bad
        r = _freeze(frozen, r_n, r)
        Dsel = _freeze(frozen, Dsel_n, Dsel)
        Linv = _freeze(frozen, Linv_n, Linv)
        idx = _freeze(frozen, idx_n, idx)
        a0sel = _freeze(frozen, a0sel_n, a0sel)
        err = _freeze(frozen, err_n, err)
        nsel = torch.where(frozen, nsel, nsel + 1)
        done = frozen | (err <= eps * eps) if eps_mode else frozen
    gamma = _solve_gamma(Linv, a0sel)
    valid = torch.arange(T, device=dev)[None, :] < nsel[:, None]
    return GreedyResult(idx, torch.where(valid, gamma, 0.0), err, nsel)


def _fused_supported(D: torch.Tensor, X: torch.Tensor, T: int) -> bool:
    """The fused kernel takes the call: CUDA tensors, float32, and a shape
    inside the kernel's envelope."""
    from lyssandra_tpu_torch.ops.cuda_omp import kernel_supports

    return (
        X.is_cuda and D.is_cuda
        and D.dtype == torch.float32 and X.dtype == torch.float32
        and kernel_supports(D.shape[0], T)
    )


def _omp_fused_call(D, X, *, T, eps, eps_mode, dense):
    """The fused solve (ops/cuda_omp.omp_fused): the CUDA kernel for GPU
    tensors, its plain version for CPU tensors."""
    from lyssandra_tpu_torch.ops.cuda_omp import omp_fused

    res = GreedyResult(*omp_fused(D, X, T=T, eps=eps, eps_mode=eps_mode))
    return res.dense(D.shape[1]) if dense else res


def _as_f32(A, device) -> torch.Tensor:
    return torch.as_tensor(A, dtype=torch.float32, device=device)


def batch_omp(D, X, T: int, eps: float | None = None, *,
              dense: bool = True, refresh: str = "auto", device=None):
    """Batch-OMP (oracle.batch_omp semantics).

    D: (p, K) unit-norm dictionary.  X: (p, N) signals.  T-sparse mode
    (eps=None) or error-constrained mode (stop when ||r||_2 <= eps, never
    exceeding T atoms).  Returns Gamma (K, N) if dense, else GreedyResult.
    Inputs go to ``device`` (default: where D lies).

    refresh: how the per-step correlation D^T r is updated when the fused
    kernel does not take the call.
      'gram'     — alpha = alpha0 - Gamma G (also forces this form on GPU);
      'residual' — alpha = (x - D_I gamma)^T D;
      'auto'     — the fused kernel where supported, else by flop count
                   (residual iff 2p < K).
    """
    if device is None and isinstance(D, torch.Tensor):
        device = D.device
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    p, K = D.shape
    if refresh not in ("auto", "gram", "residual"):
        raise ValueError(f"refresh must be auto, gram or residual: {refresh}")
    if refresh != "gram" and _fused_supported(D, X, T):
        return _omp_fused_call(
            D, X, T=T, eps=0.0 if eps is None else float(eps),
            eps_mode=eps is not None, dense=dense)
    if refresh == "auto":
        refresh = "residual" if 2 * p < K else "gram"
    if refresh == "residual":
        res = _omp_impl(D, X, 0.0 if eps is None else float(eps), T=T,
                        eps_mode=eps is not None)
    else:
        res = _batch_omp_impl(
            D.T @ D, D.T, X.T @ D, (X * X).sum(dim=0),
            0.0 if eps is None else float(eps), T=T,
            eps_mode=eps is not None)
    return res.dense(K) if dense else res


def omp(D, X, T: int, eps: float | None = None, *, dense: bool = True,
        device=None):
    """Orthogonal Matching Pursuit with explicit residual (oracle.omp)."""
    if device is None and isinstance(D, torch.Tensor):
        device = D.device
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    if _fused_supported(D, X, T):
        return _omp_fused_call(
            D, X, T=T, eps=0.0 if eps is None else float(eps),
            eps_mode=eps is not None, dense=dense)
    res = _omp_impl(D, X, 0.0 if eps is None else float(eps), T=T,
                    eps_mode=eps is not None)
    return res.dense(D.shape[1]) if dense else res
