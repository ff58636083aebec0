"""Atom-axis (model-parallel) OMP for dictionaries too large to replicate
(``lyssandra_tpu.parallel.model_sharded`` counterpart).

Layout on a ('data', 'model') mesh:
    X     : (p, N)  split over 'data' (patch axis)
    D     : (p, K)  split over 'model' (atom axis), repeated on 'data'
    codes : GreedyResult pieces, gathered on the first slot

Each data row runs its pursuit on its own.  Per step, every slot (i, j)
scores only its K/m atoms against the row's residual, with
``torch.matmul`` as the reference does, and two cross-slot operations
make the step global:

    1. selection: each slot's max |score| and first local argmax; over the
       row's slots the max, then the smallest global index among the slots
       that reach it, which is the replicated solver's first-index
       tie-break;
    2. atom fetch: each slot reads the column of its own local argmax, and
       the row's first slot sums the winner's column with zeros from the
       others, which is exact (the reference's one-hot product is a TPU
       workaround, and is left out).

The per-lane T x T state (``greedy._append_cholesky_inv``,
``greedy._solve_gamma``) is computed once per row, on its first slot,
which then sends the new residual (p floats a lane, as the atom costs) to
the row's other slots; the reference computes it redundantly on every
'model' device, with the same values.  Nothing is read on the host inside
the T-step loop: frozen and finished lanes are masks on the device.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch.parallel.collectives import (
    broadcast,
    gather_to,
    slot_max,
    slot_min,
    slot_sum,
)
from lyssandra_tpu_torch.parallel.mesh import (
    Mesh,
    data_shards,
    global_tensor,
    mesh_device,
    shard,
)
from lyssandra_tpu_torch.solvers.greedy import (
    GreedyResult,
    _append_cholesky_inv,
    _argmax_first,
    _freeze,
    _solve_gamma,
)


def _select_and_fetch(r, Dl, offsets, K):
    """One selection over a row: the global atom k (N,) and its column dk
    (N, p), both on r's device.  Dl: the row's atom blocks, one per slot."""
    dev0 = r.device
    rs = broadcast(r, [d.device for d in Dl])
    mx_l, k_l, col_l = [], [], []
    for rj, Dj in zip(rs, Dl):
        s = torch.matmul(rj, Dj).abs()                  # (N, Km)
        kj = _argmax_first(s)
        mx_l.append(s.amax(dim=1))
        k_l.append(kj)
        col_l.append(Dj.T[kj.long()])                   # (N, p)
    mx = slot_max(mx_l, dev0)
    cand = [torch.where(m == mx, k + off, K)
            for m, k, off in zip(gather_to(mx_l, dev0), gather_to(k_l, dev0),
                                 offsets)]
    k = slot_min(cand, dev0)
    dk = slot_sum([torch.where((c == k)[:, None], col, 0.0)
                   for c, col in zip(cand, gather_to(col_l, dev0))], dev0)
    return k.to(torch.int32), dk


def _omp_row(Dl, X, offsets, K, T, eps, eps_mode):
    """The pursuit of one data row: Dl its slots' atom blocks, X (p, N) its
    patches on its first slot.  Returns its GreedyResult."""
    p, N = X.shape
    dev, dt = X.device, X.dtype
    Xt = X.T
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
        k, dk = _select_and_fetch(r, Dl, offsets, K)
        g = torch.einsum("ntp,np->nt", Dsel, dk)
        Linv_n, nu = _append_cholesky_inv(Linv, g, t)
        Dsel_n = Dsel.clone()
        Dsel_n[:, t] = dk
        idx_n = idx.clone()
        idx_n[:, t] = k
        a0sel_n = a0sel.clone()
        a0sel_n[:, t] = (dk * Xt).sum(dim=1)
        gamma = _solve_gamma(Linv_n, a0sel_n)
        r_n = Xt - torch.einsum("nt,ntp->np", gamma, Dsel_n)
        err_n = (r_n * r_n).sum(dim=1)
        frozen = done | (nu <= 1e-6)
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


def omp_model_sharded(D, X, T: int, eps: float | None = None, *,
                      mesh: Mesh, dense: bool = True):
    """OMP with the dictionary split over the mesh's 'model' axis and the
    patches over 'data'.  For K too large to replicate on one slot; per
    patch the output matches the replicated ``omp``.  D, X: tensors,
    arrays or ShardedTensors.  Returns Gamma (K, N) if dense, else a
    GreedyResult, on the mesh's first slot."""
    first = mesh_device(mesh)
    D = global_tensor(D, first)
    X = global_tensor(X, first)
    K = D.shape[1]
    if K < mesh.shape["model"]:
        raise ValueError(f"K={K} atoms cannot split over "
                         f"model={mesh.shape['model']} slots")
    Ds = shard(D, mesh, (None, "model"))
    sizes = [b.shape[1] for b in Ds.shards[0]]
    offsets = [sum(sizes[:j]) for j in range(len(sizes))]
    eps_mode = eps is not None
    eps = 0.0 if eps is None else float(eps)
    rows = [_omp_row(list(Ds.shards[i]), x, offsets, K, T, eps, eps_mode)
            for i, x in enumerate(data_shards(X, mesh))]
    res = GreedyResult.concatenate(gather_to(rows, first))
    return res.dense(K) if dense else res
