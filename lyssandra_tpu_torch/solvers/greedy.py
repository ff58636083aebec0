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

from lyssandra_tpu_torch._device import resolve_device


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


def _argmax_first(A: torch.Tensor) -> torch.Tensor:
    """First index of the max A[n, :] per row (np.argmax tie rule)."""
    mx = A.amax(dim=1, keepdim=True)
    return (A == mx).to(torch.uint8).argmax(dim=1).to(torch.int32)


def _argmax_abs(A: torch.Tensor) -> torch.Tensor:
    """First index of the max |A[n, :]| per row (np.argmax tie rule)."""
    return _argmax_first(A.abs())


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


def _check_corr_dtype(corr_dtype: str) -> None:
    if corr_dtype not in ("f32", "bf16"):
        raise ValueError(f"corr_dtype must be 'f32' or 'bf16': {corr_dtype!r}")


def _omp_impl(D, X, eps, *, T, eps_mode, corr_dtype="f32",
              fused_select=False, M=None):
    """Explicit-residual OMP (oracle.omp): correlations from
    r = x - D_I gamma.  In eps mode a lane is done once its residual
    reaches the target, and the whole loop ends once every lane is done
    (one host sync per step).

    corr_dtype='bf16': the selection product alone takes bf16-rounded
    operands, accumulated in float32 (a product of two bf16 values is
    exact in float32); the factor, solves and residuals stay float32.

    fused_select=True: each step's selection is one launch of the fused
    selection kernel (``ops/cuda_select.py``), which never writes the
    (N, K) correlation; on CPU tensors its wrapper runs the same ops as
    the unfused selection.  Off by default, as in the reference.

    M (p, N) 0/1 observation mask: masked OMP (oracle.masked_omp) over
    each lane's observed coordinates, in float32 with the plain selection.
    It codes M o x over the masked atoms M o d_k, selecting by
    |d^T r| / ||M o d_k|| (the residual is masked by construction, so the
    product needs no mask); an atom whose masked norm is <= 1e-6 scores -1
    and is never picked over a valid one.  The factor is built over the
    unit-normalised masked atoms, and the codes are rescaled to the
    unnormalised ones at the end."""
    _check_corr_dtype(corr_dtype)
    p, K = D.shape
    N = X.shape[1]
    dev, dt = D.device, D.dtype
    Xt = X.T                                   # (N, p)
    Dt = D.T
    if M is not None:
        Mt = M.T.to(dt)
        Xt = Xt * Mt                           # observed coordinates only
        nrm = torch.sqrt((Mt @ (D * D)).clamp_min(0.0))      # (N, K)
        invalid = nrm <= 1e-6

        def select(r):
            return _argmax_first(torch.where(
                invalid, -1.0, (r @ D).abs() / nrm.clamp_min(1e-6)))

        def atom(k):
            nk = nrm.gather(1, k.long()[:, None])[:, 0]
            return (Dt[k.long()] * Mt / nk.clamp_min(1e-6)[:, None],
                    nk <= 1e-6)
    else:
        # imported here: ops/cuda_select.py imports this module
        from lyssandra_tpu_torch.ops import cuda_select

        # CPU tensors go to the wrapper too, whose plain version runs there
        if fused_select and cuda_select.takes(D, X, any_device=True):
            def select(r):
                return cuda_select.select_abs_argmax(
                    r, D, bf16=corr_dtype == "bf16")
        else:
            D_sel = D.bfloat16().float() if corr_dtype == "bf16" else D

            def select(r):
                r_sel = r.bfloat16().float() if corr_dtype == "bf16" else r
                return _argmax_abs(r_sel @ D_sel)

        def atom(k):
            return Dt[k.long()], False
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
        k = select(r)
        dk, bad_atom = atom(k)                               # (N, p)
        g = torch.einsum("ntp,np->nt", Dsel, dk)
        Linv_n, nu = _append_cholesky_inv(Linv, g, t)
        bad = (nu <= 1e-6) | bad_atom
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
    if M is not None:
        gamma = gamma / nrm.gather(1, idx.long()).clamp_min(1e-6)
    valid = torch.arange(T, device=dev)[None, :] < nsel[:, None]
    return GreedyResult(idx, torch.where(valid, gamma, 0.0), err, nsel)


def omp_route(device_type: str, D_dtype: torch.dtype, X_dtype: torch.dtype,
              corr_dtype: str, p: int, K: int, T: int) -> str:
    """Which fused OMP solve takes a call, from what the call is:

    'gram'     — ``cuda_omp.omp_fused`` (K1/K2 in the Gram form) wherever
                 its block state fits shared memory;
    'residual' — ``cuda_omp.omp_residual_fused`` (the residual form, no
                 state that grows with K) elsewhere where it takes the
                 shape: p <= 512, which is also the reference's gate
                 (``lyssandra_tpu/solvers/greedy.py::_fused_supported``),
                 and a state that fits;
    'plain'    — no kernel: tensors off the GPU, types other than float32,
                 ``corr_dtype='bf16'`` (neither kernel has a bf16
                 selection, as the reference's has none), or p > 512 with K
                 above the Gram form's cap, where the reference leaves its
                 kernel too.
    """
    from lyssandra_tpu_torch.ops import _launch, cuda_omp

    if (corr_dtype != "f32"
            or not _launch.kernel_types(device_type, D_dtype, X_dtype)):
        return "plain"
    if cuda_omp.kernel_supports(p, K, T):
        return "gram"
    if cuda_omp.residual_kernel_supports(p, K, T):
        return "residual"
    return "plain"


def _route_of(D: torch.Tensor, X: torch.Tensor, T: int,
              corr_dtype: str = "f32") -> str:
    """``omp_route`` of a call on (D, X)."""
    p, K = D.shape
    return omp_route("cuda" if X.is_cuda and D.is_cuda else "cpu", D.dtype,
                     X.dtype, corr_dtype, p, K, T)


def _fused_supported(D: torch.Tensor, X: torch.Tensor, T: int,
                     corr_dtype: str = "f32") -> bool:
    """A fused kernel takes the call (``omp_route`` is not 'plain')."""
    return _route_of(D, X, T, corr_dtype) != "plain"


def _omp_fused_call(D, X, *, T, eps, eps_mode, dense):
    """The fused solve: the kernel ``omp_route`` names for GPU tensors
    (``cuda_omp.omp_fused`` or ``omp_residual_fused``), the plain version
    for CPU tensors."""
    from lyssandra_tpu_torch.ops import cuda_omp

    fn = (cuda_omp.omp_residual_fused if _route_of(D, X, T) == "residual"
          else cuda_omp.omp_fused)
    res = GreedyResult(*fn(D, X, T=T, eps=eps, eps_mode=eps_mode))
    return res.dense(D.shape[1]) if dense else res


def _as_f32(A, device) -> torch.Tensor:
    return torch.as_tensor(A, dtype=torch.float32, device=device)


def batch_omp(D, X, T: int, eps: float | None = None, *,
              precision=None, dense: bool = True, refresh: str = "auto",
              corr_dtype: str = "f32", device=None):
    """Batch-OMP (oracle.batch_omp semantics).

    D: (p, K) unit-norm dictionary.  X: (p, N) signals.  T-sparse mode
    (eps=None) or error-constrained mode (stop when ||r||_2 <= eps, never
    exceeding T atoms).  Returns Gamma (K, N) if dense, else GreedyResult.
    Inputs go to ``device`` (default: where the first tensor input lies,
    else the GPU; see ``_device.resolve_device``).

    refresh: how the per-step correlation D^T r is updated when the fused
    kernel does not take the call.
      'gram'     — alpha = alpha0 - Gamma G (also forces this form on GPU);
      'residual' — alpha = (x - D_I gamma)^T D;
      'auto'     — the fused kernel where supported, else by flop count
                   (residual iff 2p < K).
    corr_dtype: 'f32', or 'bf16' for bf16 operands of the residual form's
    selection product (see ``_omp_impl``; the Gram form ignores it, as the
    reference's does).
    ``precision`` is accepted for the reference's signature and ignored:
    the port's numerics are always full float32.
    """
    del precision
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    p, K = D.shape
    if refresh not in ("auto", "gram", "residual"):
        raise ValueError(f"refresh must be auto, gram or residual: {refresh}")
    _check_corr_dtype(corr_dtype)
    if refresh != "gram" and _fused_supported(D, X, T, corr_dtype):
        return _omp_fused_call(
            D, X, T=T, eps=0.0 if eps is None else float(eps),
            eps_mode=eps is not None, dense=dense)
    if refresh == "auto":
        refresh = "residual" if 2 * p < K else "gram"
    if refresh == "residual":
        res = _omp_impl(D, X, 0.0 if eps is None else float(eps), T=T,
                        eps_mode=eps is not None, corr_dtype=corr_dtype)
    else:
        res = _batch_omp_impl(
            D.T @ D, D.T, X.T @ D, (X * X).sum(dim=0),
            0.0 if eps is None else float(eps), T=T,
            eps_mode=eps is not None)
    return res.dense(K) if dense else res


def omp(D, X, T: int, eps: float | None = None, *, precision=None,
        dense: bool = True, corr_dtype: str = "f32", fused: bool = True,
        device=None):
    """Orthogonal Matching Pursuit with explicit residual (oracle.omp).
    ``fused=False`` forces the batched form on any device; ``corr_dtype``
    as in ``batch_omp``.  ``precision`` is accepted for the reference's
    signature and ignored: the port's numerics are always full float32."""
    del precision
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    if fused and _fused_supported(D, X, T, corr_dtype):
        return _omp_fused_call(
            D, X, T=T, eps=0.0 if eps is None else float(eps),
            eps_mode=eps is not None, dense=dense)
    res = _omp_impl(D, X, 0.0 if eps is None else float(eps), T=T,
                    eps_mode=eps is not None, corr_dtype=corr_dtype)
    return res.dense(D.shape[1]) if dense else res


def _chol_small_inv(S: torch.Tensor, gs: int, jitter, *,
                    pivot_min: float = 0.0, floor: float = 1e-30):
    """Unrolled Cholesky of batched tiny SPD blocks and its inverse factor.

    S: (N, gs, gs) (only the lower triangle is read); jitter: scalar or
    (N,) added to the diagonal.  Returns (Linv (N, gs, gs), zero above the
    diagonal; ok (N,) = every pivot > pivot_min).  A pivot is clamped to
    ``floor`` before its square root.  The defaults are the scan solver's;
    the fused kernel's plain version passes pivot_min=1e-8, floor=1e-12.
    """
    L = [[None] * gs for _ in range(gs)]
    ok = None
    for i in range(gs):
        s = S[:, i, i] + jitter
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        okk = s > pivot_min
        ok = okk if ok is None else (ok & okk)
        dii = torch.sqrt(s.clamp_min(floor))
        L[i][i] = dii
        inv_dii = 1.0 / dii
        for j in range(i + 1, gs):
            s2 = S[:, j, i]
            for k in range(i):
                s2 = s2 - L[j][k] * L[i][k]
            L[j][i] = s2 * inv_dii
    zero = torch.zeros_like(L[0][0])
    inv = [[zero] * gs for _ in range(gs)]
    for j in range(gs):
        for i in range(j, gs):
            acc = zero
            for k in range(j, i):
                acc = acc - L[i][k] * inv[k][j]
            if i == j:
                acc = acc + 1.0
            inv[i][j] = acc / L[i][i]
    Linv = torch.stack([torch.stack(row, dim=-1) for row in inv], dim=-2)
    return Linv, ok


def _refined_solve(Linv, a0sel, Dsel, Xt):
    """gamma = (L L^T)^{-1} a0 followed by two rounds of iterative
    refinement against the explicit residual.  Returns (gamma, r)."""
    gamma = _solve_gamma(Linv, a0sel)
    for _ in range(2):
        r = Xt - torch.einsum("na,nap->np", gamma, Dsel)
        gamma = gamma + _solve_gamma(
            Linv, torch.einsum("nap,np->na", Dsel, r))
    return gamma, Xt - torch.einsum("na,nap->np", gamma, Dsel)


def _group_omp_impl(D, X, members, mmask, member_oh, eps, *, n_groups: int,
                    gs: int, T: int, eps_mode: bool):
    """Progressive block inverse-Cholesky group pursuit (the reference's
    scan, batched over lanes).

    members: (n_groups, gs) atom ids, padded slots 0; mmask: their validity.
    The active set lives in T group slots of gs atom slots (A = T*gs), and
    each step appends a gs-wide block to the inverse factor:

        W = Linv g_cross,  S = G_new - W^T W,  Lb = chol(S),
        new rows = [-Lb^{-1} W^T Linv | Lb^{-1}].

    Padded member slots carry identity rows, so their coefficients are 0.
    A failed block factorization is retried with a ridge of
    1e-2 (max|S| + 1e-3); if that fails too the lane freezes.  Lanes also
    freeze once every group is selected and, in eps mode, on convergence.
    """
    p, K = D.shape
    N = X.shape[1]
    A = T * gs
    dev, dt = D.device, D.dtype
    Xt = X.T
    Dt = D.T
    eye = torch.eye(gs, dtype=dt, device=dev)
    rows = torch.arange(N, device=dev)
    r = Xt
    Dsel = torch.zeros((N, A, p), dtype=dt, device=dev)
    Linv = torch.zeros((N, A, A), dtype=dt, device=dev)
    idx = torch.zeros((N, A), dtype=torch.int32, device=dev)
    smask = torch.zeros((N, A), dtype=dt, device=dev)
    a0sel = torch.zeros((N, A), dtype=dt, device=dev)
    gsel = torch.zeros((N, n_groups), dtype=torch.bool, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    err = (Xt * Xt).sum(dim=1)
    gamma = torch.zeros((N, A), dtype=dt, device=dev)
    nsel = torch.zeros((N,), dtype=torch.int32, device=dev)
    for t in range(T):
        stop = done | gsel.all(dim=1)
        if eps_mode:
            stop = stop | (err <= eps * eps)
        corr = r @ D
        # selected groups lose 1e30 (the reference's masking)
        S = (corr * corr) @ member_oh - 1e30 * gsel.to(dt)
        gbest = _argmax_first(S).long()
        midx = members[gbest]                                 # (N, gs)
        mvalid = mmask[gbest].to(dt)
        dnew = Dt[midx.long()] * mvalid[..., None]            # (N, gs, p)
        W = Linv @ torch.einsum("nap,ngp->nag", Dsel, dnew)   # (N, A, gs)
        Gnn = dnew @ dnew.transpose(1, 2) + eye * (1.0 - mvalid)[:, :, None]
        Schur = Gnn - W.transpose(1, 2) @ W
        scale = Schur.abs().amax(dim=(1, 2)) + 1e-3
        if gs <= 8:
            Lbinv1, ok1 = _chol_small_inv(Schur, gs, 1e-9)
            Lbinv2, ok2 = _chol_small_inv(Schur, gs, 1e-2 * scale)
            Lbinv = torch.where(ok1[:, None, None], Lbinv1, Lbinv2)
            bad = ~ok1 & ~ok2
        else:
            # LAPACK for big blocks; info != 0 marks a failed factor
            Lb, info = torch.linalg.cholesky_ex(Schur + 1e-9 * eye)
            retry = info != 0
            Lb2, info2 = torch.linalg.cholesky_ex(
                Schur + (1e-2 * scale)[:, None, None] * eye)
            Lb = torch.where(retry[:, None, None], Lb2, Lb)
            bad = retry & (info2 != 0)
            Lb = torch.where(bad[:, None, None], eye, Lb)
            Lbinv = torch.linalg.solve_triangular(
                Lb, eye.expand_as(Lb), upper=False)
        Lbinv = torch.where(bad[:, None, None], eye, Lbinv)
        sl = slice(t * gs, (t + 1) * gs)
        newrows = -(Lbinv @ W.transpose(1, 2) @ Linv)         # (N, gs, A)
        newrows[:, :, sl] = Lbinv
        Linv_n = Linv.clone()
        Linv_n[:, sl] = newrows
        Dsel_n = Dsel.clone()
        Dsel_n[:, sl] = dnew
        idx_n = idx.clone()
        idx_n[:, sl] = midx
        smask_n = smask.clone()
        smask_n[:, sl] = mvalid
        a0sel_n = a0sel.clone()
        a0sel_n[:, sl] = torch.einsum("ngp,np->ng", dnew, Xt)
        gamma_n, r_n = _refined_solve(Linv_n, a0sel_n, Dsel_n, Xt)
        gsel_n = gsel.clone()
        gsel_n[rows, gbest] = True
        frozen = stop | bad
        r = _freeze(frozen, r_n, r)
        Dsel = _freeze(frozen, Dsel_n, Dsel)
        Linv = _freeze(frozen, Linv_n, Linv)
        idx = _freeze(frozen, idx_n, idx)
        smask = _freeze(frozen, smask_n, smask)
        a0sel = _freeze(frozen, a0sel_n, a0sel)
        gsel = _freeze(frozen, gsel_n, gsel)
        err = _freeze(frozen, (r_n * r_n).sum(dim=1), err)
        gamma = _freeze(frozen, gamma_n, gamma)
        nsel = torch.where(frozen, nsel, nsel + 1)
        done = frozen
    return GreedyResult(idx, gamma * smask, err, nsel * gs)


def _scatter_dense(res: GreedyResult, K: int) -> torch.Tensor:
    """Dense Gamma (K, N) as a plain scatter-add of gamma at idx."""
    C = torch.zeros((res.idx.shape[0], K), dtype=res.gamma.dtype,
                    device=res.gamma.device)
    C.scatter_add_(1, res.idx.long(), res.gamma)
    return C.T


def group_omp(D, X, groups, T: int, eps: float | None = None, *,
              precision=None, dense: bool = True, fused: bool = True,
              interpret: bool = False, packed: bool = True, device=None):
    """Group OMP (oracle.group_omp): select argmax_g ||D_g^T r||, least
    squares over the union of the selected groups' atoms.

    groups: (K,) int group ids in [0, n_groups) (numpy, list or tensor).
    Returns dense Gamma (K, N), or with ``dense=False`` a compact
    GreedyResult whose T*gs slots hold the selected groups' atoms (gs =
    the largest group; padded slots carry 0) and whose nsel counts atom
    slots.  T is clamped to the number of groups.

    In T mode on CUDA float32 tensors, when the kernel takes the shape,
    the fused CUDA kernel (``ops/cuda_group.py``) runs all steps;
    ``fused=False`` forces the batched scan, which also serves eps mode,
    the CPU and other shapes.  ``precision``, ``interpret`` and
    ``packed`` are accepted for the reference's signature and ignored:
    they choose between TPU variants of one computation, one CUDA kernel
    serves both of the reference's kernel variants, and the port's
    numerics are always full float32.
    """
    del precision, interpret, packed
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    from lyssandra_tpu_torch.ops import cuda_group

    members, mmask, n_groups, gs = cuda_group.slot_table(groups)
    K = D.shape[1]
    T_eff = min(T, n_groups)
    if fused and eps is None and cuda_group.takes(D, X, gs, T_eff):
        idx, gamma, err, nsel, _ = cuda_group.group_omp_fused(
            D, X, groups, T_eff)
        res = GreedyResult(idx, gamma, err, nsel * gs)
    else:
        member_oh = torch.nn.functional.one_hot(
            torch.as_tensor(cuda_group.groups_numpy(groups),
                            device=D.device),
            n_groups).to(D.dtype)
        res = _group_omp_impl(
            D, X, torch.as_tensor(members, device=D.device),
            torch.as_tensor(mmask, device=D.device), member_oh,
            0.0 if eps is None else float(eps), n_groups=n_groups, gs=gs,
            T=T_eff, eps_mode=eps is not None)
    return _scatter_dense(res, K) if dense else res


def threshold_code(D, X, lam: float, kind: str = "soft", *, device=None):
    """One-shot thresholding coder: Gamma = shrink(D^T X, lam), soft or
    hard (oracle parity)."""
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    A = D.T @ X
    if kind == "soft":
        return torch.sign(A) * (A.abs() - lam).clamp_min(0.0)
    return A * (A.abs() > lam)


def masked_omp(D, X, M, T: int, eps: float | None = None, *,
               precision=None, dense: bool = True, device=None):
    """Masked (inpainting) OMP: each lane's pursuit over its observed
    coordinates (oracle.masked_omp).  M: (p, N) 0/1 observation mask.
    Returns Gamma (K, N) if dense, else GreedyResult.  Inputs go to
    ``device`` (default: where the first tensor input lies, else the GPU).
    ``precision`` is accepted for the reference's signature and ignored:
    the port's numerics are always full float32."""
    del precision
    device = resolve_device(device, D, X, M)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    M = _as_f32(M, device)
    res = _omp_impl(D, X, 0.0 if eps is None else float(eps), T=T,
                    eps_mode=eps is not None, M=M)
    return res.dense(D.shape[1]) if dense else res


def _nn_masked_cg(Gs, pos, rhs, iters: int):
    """CG on the active block of Gs (pos = 0/1 slot mask), with 1e-8 added
    to the active diagonal and 1 on the inactive one; returns x * pos."""
    d = Gs.shape[1]
    eye = torch.eye(d, dtype=rhs.dtype, device=rhs.device)
    Mm = Gs * (pos[:, :, None] * pos[:, None, :]) \
        + eye[None] * torch.where(pos > 0, 1e-8, 1.0)[:, :, None]
    x = torch.zeros_like(rhs)
    res = rhs
    pv = res
    rs = (res * res).sum(dim=1)
    for _ in range(iters):
        Mp = torch.einsum("nts,ns->nt", Mm, pv)
        al = rs / ((pv * Mp).sum(dim=1) + 1e-30)
        x = x + al[:, None] * pv
        res = res - al[:, None] * Mp
        rs2 = (res * res).sum(dim=1)
        pv = res + (rs2 / (rs + 1e-30))[:, None] * pv
        rs = rs2
    return x * pos


def _nn_err(xnormsq, gamma, a0sel, Gsel):
    """||x - D_I gamma||^2 from the restricted Gram."""
    return (xnormsq - 2 * (gamma * a0sel).sum(dim=1)
            + torch.einsum("nt,ntj,nj->n", gamma, Gsel, gamma))


def _nn_omp_impl(D, X, *, T, nnls_rounds):
    """Batched non-negative OMP (oracle.nn_omp), the reference's scan form.

    Selection is the argmax of the signed residual correlation, selected
    atoms excluded by a 1e30 penalty; a lane freezes once its best
    correlation is <= 0.  Each step solves the NNLS over the active set by
    prune-only Lawson-Hanson: ``nnls_rounds`` rounds of a masked CG of T+2
    iterations over the (N, T, T) restricted Gram, pruning negative
    coefficients after each."""
    p, K = D.shape
    N = X.shape[1]
    dev, dt = X.device, X.dtype
    Xt = X.T
    Dt = D.T
    xnormsq = (Xt * Xt).sum(dim=1)
    r = Xt
    Dsel = torch.zeros((N, T, p), dtype=dt, device=dev)
    Gsel = torch.zeros((N, T, T), dtype=dt, device=dev)
    idx = torch.zeros((N, T), dtype=torch.int32, device=dev)
    a0sel = torch.zeros((N, T), dtype=dt, device=dev)
    smask = torch.zeros((N, T), dtype=dt, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    gamma = torch.zeros((N, T), dtype=dt, device=dev)
    nsel = torch.zeros((N,), dtype=torch.int32, device=dev)
    for t in range(T):
        sel = torch.zeros((N, K), dtype=dt, device=dev)
        sel.scatter_add_(1, idx.long(), smask)
        s = r @ D - 1e30 * sel
        k = _argmax_first(s)
        stop = done | (s.amax(dim=1) <= 0.0)
        dk = Dt[k.long()]                                    # (N, p)
        grow = torch.einsum("ntp,np->nt", Dsel, dk) * smask  # G[I, k]
        Gsel_n = Gsel.clone()
        Gsel_n[:, t, :] += grow
        Gsel_n[:, :, t] += grow
        Gsel_n[:, t, t] += 1.0
        Dsel_n = Dsel.clone()
        Dsel_n[:, t] = dk
        idx_n = idx.clone()
        idx_n[:, t] = k
        a0sel_n = a0sel.clone()
        a0sel_n[:, t] = (dk * Xt).sum(dim=1)
        smask_n = smask.clone()
        smask_n[:, t] = 1.0
        pos = smask_n
        g = torch.zeros_like(a0sel_n)
        for _ in range(nnls_rounds):
            g = _nn_masked_cg(Gsel_n, pos, a0sel_n * pos, T + 2)
            pos = pos * (g > 0)
        gamma_n = g.clamp_min(0.0) * pos
        r_n = Xt - torch.einsum("nt,ntp->np", gamma_n, Dsel_n)
        r = _freeze(stop, r_n, r)
        Dsel = _freeze(stop, Dsel_n, Dsel)
        Gsel = _freeze(stop, Gsel_n, Gsel)
        idx = _freeze(stop, idx_n, idx)
        a0sel = _freeze(stop, a0sel_n, a0sel)
        smask = _freeze(stop, smask_n, smask)
        gamma = _freeze(stop, gamma_n, gamma)
        nsel = torch.where(stop, nsel, nsel + 1)
        done = stop
    return GreedyResult(idx, gamma, _nn_err(xnormsq, gamma, a0sel, Gsel),
                        nsel)


def _nn_omp_impl_unrolled(D, X, *, T, nnls_rounds):
    """Unrolled-step nn_omp (the semantics of ``_nn_omp_impl``): step t's
    system is (t+1)-dimensional, so its masked CG runs t+2 iterations on
    (N, t+1, t+1); step 0's one-atom NNLS is a closed-form divide.  Frozen
    lanes take a zero atom, so their new slot is inert."""
    K = D.shape[1]
    N = X.shape[1]
    dev, dt = X.device, X.dtype
    Xt = X.T
    Dt = D.T
    xnormsq = (Xt * Xt).sum(dim=1)
    rows = torch.arange(N, device=dev)
    r = Xt
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    selpen = torch.zeros((N, K), dtype=dt, device=dev)   # 1e30 per pick
    Gsel = Dstack = None
    gamma = torch.zeros((N, 0), dtype=dt, device=dev)
    a0sel = torch.zeros((N, 0), dtype=dt, device=dev)
    smask = torch.zeros((N, 0), dtype=dt, device=dev)
    idx = torch.zeros((N, 0), dtype=torch.int32, device=dev)
    nsel = torch.zeros((N,), dtype=torch.int32, device=dev)
    for t in range(T):
        s = r @ D - selpen
        k = _argmax_first(s)
        stop = done | (s.amax(dim=1) <= 0.0)
        livef = (~stop).to(dt)
        selpen.index_put_((rows, k.long()), 1e30 * livef, accumulate=True)
        dk = Dt[k.long()] * livef[:, None]                   # (N, p)
        a0k = (dk * Xt).sum(dim=1)
        if t == 0:
            Gsel = (dk * dk).sum(dim=1)[:, None, None]
            Dstack = dk[:, None, :]
        else:
            cross = torch.einsum("ntp,np->nt", Dstack, dk)    # (N, t)
            dkk = (dk * dk).sum(dim=1)
            Gsel = torch.cat([
                torch.cat([Gsel, cross[:, :, None]], dim=2),
                torch.cat([cross[:, None, :], dkk[:, None, None]], dim=2),
            ], dim=1)
            Dstack = torch.cat([Dstack, dk[:, None, :]], dim=1)
        # idx is 0-padded after stop (the GreedyResult contract)
        idx = torch.cat([idx, torch.where(stop, 0, k)[:, None]], dim=1)
        a0sel = torch.cat([a0sel, a0k[:, None]], dim=1)
        smask = torch.cat([smask, livef[:, None]], dim=1)
        if t == 0:
            # one-atom NNLS in closed form (a0k = the max > 0 on live lanes)
            new_gamma = (a0sel / Gsel[:, :, 0].clamp_min(1e-30)).clamp_min(
                0.0) * smask
        else:
            pos = smask
            g = torch.zeros_like(a0sel)
            for _ in range(nnls_rounds):
                g = _nn_masked_cg(Gsel, pos, a0sel * pos, t + 2)
                pos = pos * (g > 0)
            new_gamma = g.clamp_min(0.0) * pos
        new_r = Xt - torch.einsum("nt,ntp->np", new_gamma, Dstack)
        gamma_prev = torch.cat([gamma, gamma.new_zeros((N, 1))], dim=1)
        gamma = torch.where(stop[:, None], gamma_prev, new_gamma)
        r = torch.where(stop[:, None], r, new_r)
        nsel = torch.where(stop, nsel, nsel + 1)
        done = stop
    return GreedyResult(idx, gamma, _nn_err(xnormsq, gamma, a0sel, Gsel),
                        nsel)


def nn_omp(D, X, T: int, *, nnls_rounds: int = 4, precision=None,
           dense: bool = True, unroll: bool | None = None, device=None):
    """Non-negative OMP (oracle.nn_omp): positive-correlation selection and
    a bounded active-set NNLS per step (prune-only Lawson-Hanson,
    ``nnls_rounds`` solve/prune passes).  Returns Gamma (K, N) >= 0, or a
    GreedyResult with ``dense=False``.

    ``unroll=None`` takes the unrolled-step form for T <= 12 and the scan
    form above, as the reference does; the two round differently.  Inputs
    go to ``device`` (default: where the first tensor input lies, else the
    GPU).  ``precision`` is accepted for the reference's signature and
    ignored: the port's numerics are always full float32."""
    del precision
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    if T == 0:
        N = X.shape[1]
        res = GreedyResult(
            torch.zeros((N, 0), dtype=torch.int32, device=device),
            torch.zeros((N, 0), dtype=X.dtype, device=device),
            (X * X).sum(dim=0), torch.zeros((N,), dtype=torch.int32,
                                            device=device))
        return res.dense(D.shape[1]) if dense else res
    if unroll is None:
        unroll = T <= 12
    impl = _nn_omp_impl_unrolled if unroll else _nn_omp_impl
    res = impl(D, X, T=T, nnls_rounds=nnls_rounds)
    return res.dense(D.shape[1]) if dense else res
