"""Locality-constrained Linear Coding (Wang et al. 2010;
``lyssandra_tpu.solvers.llc`` counterpart).

Per signal x: take the k nearest atoms B, solve the shift-invariant
constrained least squares

    min_c ||x - B c||^2 + lam ||c||^2   s.t.  1^T c = 1

through the analytic form  C = (B - 1 x^T)(B - 1 x^T)^T,
c ~ solve(C + (lam tr(C) + 1e-12) I, 1), c /= 1^T c.  Matches
oracle.llc per signal.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.solvers.greedy import _as_f32


def llc(D, X, knn: int = 5, lam: float = 1e-4, *, dense: bool = True,
        device=None):
    """LLC codes over the unit-norm dictionary D (p, K) for X (p, N).

    Returns the dense Gamma (K, N) (codes sum to 1 per column, zero off the
    k-NN support), or (idx (N, k) int32, coeff (N, k)) when dense=False.
    Inputs go to ``device`` (default: where the first tensor input lies,
    else the GPU)."""
    device = resolve_device(device, D, X)
    D = _as_f32(D, device)
    X = _as_f32(X, device)
    K = D.shape[1]
    N = X.shape[1]
    # nearest atoms by euclidean distance = largest d.x for unit atoms; a
    # stable descending sort gives lax.top_k's order: values descending,
    # the lower index first among equal ones (torch.topk promises neither)
    sim = X.T @ D                                      # (N, K)
    idx = torch.sort(sim, dim=1, descending=True, stable=True).indices[
        :, :knn]
    B = D.T[idx]                                       # (N, k, p)
    z = B - X.T[:, None, :]                            # centred on x
    C = torch.einsum("nkp,nlp->nkl", z, z)
    tr = C.diagonal(dim1=1, dim2=2).sum(dim=1)
    eye = torch.eye(knn, dtype=C.dtype, device=device)
    Creg = C + (lam * tr + 1e-12)[:, None, None] * eye
    ones = torch.ones((N, knn), dtype=C.dtype, device=device)
    if knn <= 16:
        # Creg is SPD: CG is exact in knn iterations (+2 slack), as the
        # reference unrolls it
        c = torch.zeros_like(ones)
        res = ones
        pv = res
        rs = (res * res).sum(dim=1)
        for _ in range(knn + 2):
            Mp = torch.einsum("nkl,nl->nk", Creg, pv)
            al = rs / ((pv * Mp).sum(dim=1) + 1e-30)
            c = c + al[:, None] * pv
            res = res - al[:, None] * Mp
            rs2 = (res * res).sum(dim=1)
            pv = res + (rs2 / (rs + 1e-30))[:, None] * pv
            rs = rs2
    else:
        c = torch.linalg.solve(Creg, ones[..., None])[..., 0]
    c = c / c.sum(dim=1, keepdim=True)
    if not dense:
        return idx.to(torch.int32), c
    G = torch.zeros((N, K), dtype=C.dtype, device=device)
    G.scatter_add_(1, idx, c)
    return G.T
