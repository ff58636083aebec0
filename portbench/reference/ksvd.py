"""One K-SVD iteration (Aharon, Elad & Bruckstein 2006), plain, in the
approximate form of Rubinstein, Zibulevsky & Elad 2008 (one power step per
atom): code every signal with error-mode OMP over D; then for each atom k
in turn, over its users w (the signals whose code uses it), with
E = X_w - D Gamma_w + d_k gamma_k,w the error without it:
d_k = E g / ||E g||, gamma_k,w = E^T d_k (g = gamma_k,w before), an
unused atom left as it is.  Then an atom with no user, or more than
max_coherence-coherent with a later atom, takes the r-th worst-coded
signal (r its rank among such atoms, the worst first, the lower index
first among equals), normalized, and every atom is scaled to unit norm."""

import torch

from portbench.reference.omp import dense, omp


def ksvd_iteration(X, D, *, T, eps, min_use=1, max_coherence=0.99):
    """X (p, N), D (p, K) of one dtype.  Returns (new D, the coding's
    nsel)."""
    K = D.shape[1]
    N = X.shape[1]
    idx, gamma, _, nsel = omp(D, X, T, eps=eps)
    G = dense(idx, gamma, K)
    D = D.clone()
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
    return D, nsel
