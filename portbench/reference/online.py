"""Online dictionary learning (Mairal, Bach, Ponce & Sapiro 2010, JMLR 11,
Algorithms 1-2) with lasso codes by feature-sign search (Lee, Battle,
Raina & Ng 2007, NIPS 19, Algorithm 1), plain.

The lasso of a signal x over D (p, K) is min_g f(g) = ||x - D g||^2 +
lam ||g||_1.  One step of the learner over a minibatch X (p, n) with codes
Gamma (K, n):

    A <- beta A + Gamma Gamma^T,  B <- beta B + X Gamma^T,

then one Gauss-Seidel sweep over the atoms k = 0..K-1 in order, each
seeing the atoms before it:

    d_k <- proj_{||.|| <= 1}( d_k + (b_k - D a_k) / A_kk ),

an atom with A_kk < 1e-10 (no use yet) kept as it is.  The products over
all atoms are single matrix products, which TF32, where it is switched
on, rounds."""

import numpy as np
import torch


def objective(D, X, Gamma, lam):
    """f per lane: ||x - D g||^2 + lam ||g||_1, (n,)."""
    R = X - D @ Gamma
    return (R * R).sum(dim=0) + lam * Gamma.abs().sum(dim=0)


def kkt(D, X, Gamma, lam):
    """Per lane, the widest breach of the lasso's optimality conditions,
    over lam: with g = 2 D^T (D gamma - x), |g_k + lam sign(gamma_k)| where
    gamma_k != 0 and (|g_k| - lam)^+ where it is 0.  (n,)."""
    g = 2.0 * (D.T @ (D @ Gamma - X))
    on = Gamma != 0
    v = torch.where(on, (g + lam * torch.sign(Gamma)).abs(),
                    (g.abs() - lam).clamp_min(0.0))
    return v.max(dim=0).values / lam


def _first_min(f):
    """The index of the first smallest entry of each row."""
    m = f.min(dim=1, keepdim=True).values
    return torch.argmax((f == m).to(torch.int8), dim=1)


def lasso(D, X, lam, *, max_iter=1000):
    """Feature-sign search for every column of X, all lanes at once, in
    D's dtype.  Per lane, from g = 0 with no active atom:

    1. where the last step ended on its full solution, activate the
       inactive atom of largest |dF/dg_k| (the lower index among equals)
       with the sign opposite its derivative, or stop where none exceeds
       lam (1 + tol): tol 1e-9 in float64, 1e-4 in float32;
    2. solve the active set's normal equations with those signs,
       (D_S^T D_S) g_S = D_S^T x - lam theta_S / 2;
    3. move to the point of least f among the current one, the solution
       and the points between where a coefficient crosses zero (the first
       among equals; a coefficient that crosses there leaves the set), and
       take signs from it.  A lane that cannot lower f stops.

    Returns (Gamma (K, n), done (n,)): done is false for a lane that ran
    ``max_iter`` iterations or whose system could not be solved."""
    dt, dev = D.dtype, D.device
    K, N = D.shape[1], X.shape[1]
    tol = 1e-9 if dt == torch.float64 else 1e-4
    G = D.T @ D
    C = X.T @ D                                   # (N, K): D^T x a row
    xx = (X * X).sum(dim=0)
    gamma = torch.zeros((N, K + 1), dtype=dt, device=dev)   # column K: pad
    full = torch.ones((N,), dtype=torch.bool, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    run = torch.arange(N, device=dev)
    Gp = torch.zeros((K + 1, K + 1), dtype=dt, device=dev)
    Gp[:K, :K] = G
    Cp = torch.cat([C, torch.zeros((N, 1), dtype=dt, device=dev)], dim=1)
    for _ in range(max_iter):
        if run.numel() == 0:
            break
        g = gamma[run, :K]
        theta = torch.sign(g)
        grad = 2.0 * (g @ G - C[run])
        score = torch.where(theta != 0, torch.zeros_like(grad), grad.abs())
        k = _first_min(-score)
        best = score.gather(1, k[:, None])[:, 0]
        fl = full[run]
        stop = fl & (best <= lam * (1.0 + tol))
        done[run[stop]] = True
        act = fl & ~stop
        rows = torch.nonzero(act).flatten()
        theta[rows, k[rows]] = -torch.sign(grad[rows, k[rows]])
        keep = ~stop
        run, theta, g = run[keep], theta[keep], g[keep]
        if run.numel() == 0:
            break
        on = theta != 0
        cnt = on.sum(dim=1)
        m = int(cnt.max())
        idx = torch.sort(on.to(torch.int8), dim=1, descending=True,
                         stable=True).indices[:, :m]
        valid = torch.arange(m, device=dev)[None, :] < cnt[:, None]
        idx = torch.where(valid, idx, K)
        both = valid[:, :, None] & valid[:, None, :]
        eye = torch.eye(m, dtype=dt, device=dev).expand(len(run), m, m)
        M = torch.where(both, Gp[idx[:, :, None], idx[:, None, :]], eye)
        th = torch.where(valid, theta.gather(1, torch.where(valid, idx, 0)),
                         0.0)
        c = Cp[run[:, None], idx]
        rhs = torch.where(valid, c - 0.5 * lam * th, 0.0)
        sol, info = torch.linalg.solve_ex(M, rhs[:, :, None])
        sol = sol[:, :, 0]
        ok = (info == 0) & torch.isfinite(sol).all(dim=1)
        sol = torch.where(ok[:, None] & valid, sol, 0.0)
        old = gamma[run[:, None], idx]
        v = sol - old
        # the candidates: t = 0, each zero crossing in (0, 1), t = 1
        cross = valid & (old != 0) & (old * sol < 0)
        tc = torch.where(cross, old / (old - sol), 2.0)
        one = torch.ones((len(run), 1), dtype=dt, device=dev)
        t = torch.cat([0.0 * one, tc, one], dim=1)               # (n, m+2)
        pts = old[:, None, :] + t.clamp_max(1.0)[:, :, None] * v[:, None, :]
        quad = (pts * torch.bmm(pts, M)).sum(dim=2)
        f = (xx[run][:, None] - 2.0 * (pts * c[:, None, :]).sum(dim=2)
             + quad + lam * pts.abs().sum(dim=2))
        f = torch.where(t <= 1.0, f, torch.inf)
        j = _first_min(f)
        tj = t.gather(1, j[:, None])
        new = old + tj * v
        new = torch.where(cross & (tc == tj), 0.0, new)
        new = torch.where(valid, new, 0.0)
        moved = ok & (j > 0)
        gamma[run[:, None], idx] = torch.where(moved[:, None], new, old)
        gamma[:, K] = 0.0
        full[run] = (j == m + 1) & (torch.sign(new) == th).all(dim=1)
        done[run[ok & ~moved]] = True     # f cannot be lowered: optimal
        run = run[moved]
    return gamma[:, :K].T.contiguous(), done


def statistics(A, B, X, Gamma, beta):
    """(beta A + Gamma Gamma^T, beta B + X Gamma^T)."""
    return beta * A + Gamma @ Gamma.T, beta * B + X @ Gamma.T


def sweep(D, A, B, n_sweeps=1):
    """``n_sweeps`` Gauss-Seidel sweeps of the projected atom update, in
    order; returns a new D."""
    D = D.clone()
    akk = torch.diagonal(A)
    live = (akk >= 1e-10).tolist()
    akk = akk.clamp_min(1e-10)
    for _ in range(n_sweeps):
        for k in range(D.shape[1]):
            if not live[k]:
                continue
            u = D[:, k] + (B[:, k] - (D @ A[:, k:k + 1])[:, 0]) / akk[k]
            D[:, k] = u / torch.linalg.vector_norm(u).clamp_min(1.0)
    return D


def fista(D, X, lam, n_iter):
    """``n_iter`` FISTA iterations (Beck & Teboulle 2009) from 0, all lanes
    at once, with the step 1 / L, L = 2.2 lmax + 1e-6 and lmax the
    Rayleigh quotient of D^T D after 16 power steps from the constant
    unit vector (the learner's holdout metric).  Returns Gamma (K, n)."""
    K = D.shape[1]

    def gram_mv(v):
        return D.T @ (D @ v)

    v = torch.ones(K, dtype=D.dtype, device=D.device) / np.sqrt(K)
    for _ in range(16):
        w = gram_mv(v)
        v = w / torch.linalg.vector_norm(w).clamp_min(1e-12)
    L = 2.2 * torch.dot(v, gram_mv(v)) + 1e-6
    A0 = D.T @ X
    g = y = torch.zeros((K, X.shape[1]), dtype=D.dtype, device=D.device)
    t = 1.0
    for _ in range(n_iter):
        z = y - 2.0 * (gram_mv(y) - A0) / L
        gnew = torch.sign(z) * (z.abs() - lam / L).clamp_min(0.0)
        tnew = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        y = gnew + ((t - 1.0) / tnew) * (gnew - g)
        g, t = gnew, tnew
    return g


def holdout_objective(D, Xh, lam, n_iter):
    """The mean f over the columns of Xh of their FISTA codes."""
    G = fista(D, Xh, lam, n_iter)
    return objective(D, Xh, G, lam).sum() / Xh.shape[1]


def init_dictionary(X, K, seed):
    """K distinct columns of X (p, n), n >= K, drawn by a CPU
    ``torch.Generator`` seeded by ``seed``, scaled to unit norm."""
    cols = torch.randperm(X.shape[1],
                          generator=torch.Generator().manual_seed(seed))[:K]
    D = X[:, cols.to(X.device)]
    return D / torch.linalg.vector_norm(D, dim=0, keepdim=True).clamp_min(
        1e-12)
