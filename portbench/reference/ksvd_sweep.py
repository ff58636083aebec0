"""The two halves of one K-SVD iteration after its coding, plain, from
codes handed in: the B=1 atom sweep (one power step an atom) and the
replacement of bad atoms with the normalization.  The arithmetic of
``reference/ksvd.py::ksvd_iteration`` after its ``omp`` call, op for op,
so that ``from_codes(X, D, dense(omp(D, X, T)))`` is that iteration bit
for bit; a check that starts the sweep from the program's own codes sees
no flip of a near-tied pick in it.

The stats are the program's five: the post-sweep objective sum ||r||^2,
its RMS per entry, the mean number of atoms a lane, the atoms replaced,
and the coding's objective sum ||x - D gamma||^2 from the codes handed
in."""

import torch


def sweep(X, D, G):
    """(D, G) after one Gauss-Seidel sweep over the atoms in order: atom k
    over its users w, with E = R_w + d_k g and g = G[k, w],
    d_k = E g / ||E g||, G[k, w] = E^T d_k; an unused atom left as it is.
    The inputs are not changed."""
    K = D.shape[1]
    D, G = D.clone(), G.clone()
    R = X - D @ G
    for k in range(K):
        w = torch.nonzero(G[k]).flatten()
        if w.numel() == 0:
            continue
        g = G[k, w]
        E = R[:, w] + D[:, k:k + 1] * g[None, :]
        d = E @ g
        d = d / torch.linalg.vector_norm(d).clamp_min(1e-12)
        g = E.T @ d
        R[:, w] = E - d[:, None] * g[None, :]
        D[:, k] = d
        G[k, w] = g
    return D, G


def replace(X, D, G, *, min_use=1, max_coherence=0.99):
    """(D with its bad atoms replaced, every atom at unit norm; bad (K,);
    the lanes' post-sweep errors ||x - D g||^2).  An atom is bad with
    fewer than ``min_use`` users or more than ``max_coherence``-coherent
    with a later atom; the r-th bad one (in index order) takes the r-th
    worst-coded signal (the lower index first among equal errors),
    normalized."""
    K, N = D.shape[1], X.shape[1]
    R = X - D @ G
    err = (R * R).sum(dim=0)
    use = (G != 0).sum(dim=1)
    C = torch.triu((D.T @ D).abs(), diagonal=1)
    bad = (use < min_use) | (C.max(dim=1).values > max_coherence)
    order = torch.sort(err, descending=True, stable=True).indices[:min(K, N)]
    rank = torch.cumsum(bad.long(), dim=0) - 1
    repl = X[:, order[rank % order.numel()]]
    repl = repl / torch.linalg.vector_norm(repl, dim=0,
                                           keepdim=True).clamp_min(1e-10)
    D = torch.where(bad[None, :], repl, D)
    D = D / torch.linalg.vector_norm(D, dim=0, keepdim=True).clamp_min(1e-12)
    return D, bad, err


def from_codes(X, D, G, *, min_use=1, max_coherence=0.99):
    """(D out, stats (5,)) of the iteration whose coding gave the dense
    codes G (K, N) over D: the sweep from them, then the replacement."""
    Rc = X - D @ G
    obj_code = (Rc * Rc).sum()
    Ds, Gs = sweep(X, D, G)
    D_out, bad, err = replace(X, Ds, Gs, min_use=min_use,
                              max_coherence=max_coherence)
    stats = torch.stack([
        err.sum(), torch.sqrt(err.sum() / X.numel()),
        (Gs != 0).sum(dim=0).to(X.dtype).mean(), bad.sum().to(X.dtype),
        obj_code])
    return D_out, stats
