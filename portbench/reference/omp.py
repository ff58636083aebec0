"""Orthogonal Matching Pursuit, plain and batched (Pati, Rezaiifar &
Krishnaprasad 1993; the stopping rules of Rubinstein et al. 2008's
Batch-OMP): per lane, pick the atom of largest |d_k^T r| (the lowest index
among equal values), solve the least squares over the support through its
Cholesky factor, and recompute the residual r = x - D_I gamma.

Fixed-T mode runs T steps; error mode stops a lane once ||r||^2 <= eps^2
(checked before the first step too) or at T atoms.  A lane whose new atom
lies in the span of its support (the factor's new pivot nu <= 1e-6, as for
an atom picked twice) stops without it.  Only the lanes still running are
computed at each step.  The products over all atoms are single matrix
products, which TF32, where it is switched on, rounds."""

import contextlib

import torch


@contextlib.contextmanager
def tf32(on):
    """TF32 products on or off for the block (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def omp(D, X, T, eps=None):
    """D (p, K), X (p, N) of one dtype on one device.  Returns idx (N, T)
    int64 (-1 past nsel), gamma (N, T) (0 past nsel), err (N,) = ||r||^2,
    nsel (N,) int64.

    The normal equations take their entries from G = D^T D and
    A0 = X^T D, each one matrix product over all atoms (Batch-OMP's
    precomputed products), and so does the error, ||x||^2 - b^T gamma;
    the residual r = x - D_I gamma that the selection reads is recomputed
    from D."""
    p, K = D.shape
    N = X.shape[1]
    dev, dt = X.device, X.dtype
    Xt = X.T.contiguous()
    Dt = D.T.contiguous()
    G = D.T @ D
    A0 = X.T @ D
    idx = torch.full((N, T), -1, dtype=torch.long, device=dev)
    gamma = torch.zeros((N, T), dtype=dt, device=dev)
    nsel = torch.zeros((N,), dtype=torch.long, device=dev)
    xx = (Xt * Xt).sum(dim=1)
    err = xx.clone()
    lanes = torch.arange(N, device=dev)
    if eps is not None:
        lanes = lanes[err > eps * eps]
    # state of the running lanes only: support, Cholesky factor L (lower)
    sup = torch.zeros((lanes.numel(), T), dtype=torch.long, device=dev)
    L = torch.zeros((lanes.numel(), T, T), dtype=dt, device=dev)
    for t in range(T):
        if lanes.numel() == 0:
            break
        x = Xt[lanes]
        if t == 0:
            r = x
        else:
            r = x - torch.bmm(gamma[lanes, None, :t], Dt[sup[:, :t]])[:, 0]
        k = torch.argmax((r @ D).abs(), dim=1)
        nu = G[k, k]
        if t > 0:
            g = G[sup[:, :t], k[:, None]][:, :, None]          # (n, t, 1)
            w = torch.linalg.solve_triangular(L[:, :t, :t], g,
                                              upper=False)[:, :, 0]
            nu = nu - (w * w).sum(dim=1)
        ok = nu > 1e-6
        lanes, sup, L, k, nu, x = (a[ok] for a in (lanes, sup, L, k, nu, x))
        if t > 0:
            L[:, t, :t] = w[ok]
        L[:, t, t] = torch.sqrt(nu)
        sup[:, t] = k
        b = A0[lanes[:, None], sup[:, :t + 1]][:, :, None]     # (n, t+1, 1)
        Lt = L[:, :t + 1, :t + 1]
        y = torch.linalg.solve_triangular(Lt, b, upper=False)
        g = torch.linalg.solve_triangular(Lt.transpose(1, 2), y,
                                          upper=True)[:, :, 0]
        idx[lanes, :t + 1] = sup[:, :t + 1]
        gamma[lanes, :t + 1] = g
        nsel[lanes] = t + 1
        # ||r||^2 from the normal equations: ||x||^2 - b^T gamma
        err[lanes] = xx[lanes] - torch.bmm(b.transpose(1, 2),
                                           g[:, :, None])[:, 0, 0]
        if eps is not None:
            go = err[lanes] > eps * eps
            lanes, sup, L = lanes[go], sup[go], L[go]
    return idx, gamma, err, nsel


def dense(idx, gamma, K):
    """The (K, N) code matrix of compact codes (slots past nsel are -1)."""
    N, T = idx.shape
    C = torch.zeros((N, K), dtype=gamma.dtype, device=gamma.device)
    on = idx >= 0
    C.scatter_add_(1, torch.where(on, idx, 0), torch.where(on, gamma, 0.0))
    return C.T
