"""K-SVD dictionary learning (Aharon/Elad/Bruckstein 2006; approximate
variant per Rubinstein et al. 2008) — ``lyssandra_tpu.dict_learning.ksvd``
counterpart.

Each iteration codes the signals with ``SparseEncoder("bomp")`` (on a GPU
the fused OMP kernel of ``ops/cuda_omp.py`` and its G = D^T D product, one
launch each per block of 16,384 signals), sweeps the atoms, and replaces
dead or coherent atoms.

The atom sweep is a loop over the K atoms, sequential on purpose: K-SVD's
Gauss-Seidel semantics (atom k+1 sees atom k's update) are part of the
algorithm.  It keeps the residual R = X - D Gamma, so the restricted error
E_k = R + d_k gamma_k on atom k's support is never built:

    E_k (g o m) = R (g o m) + d_k (gamma_k . (g o m))        # (p,)
    E_k^T d     = m o (R^T d + gamma_k (d_k . d))            # (N,)

and a rank-1 update after each atom block keeps R current.  Every product
is a plain float32 matmul (TF32 is off package-wide).  An iteration never
reads a value on the host: the learner fetches the stats once per fit, or
once per iteration when something on the host consumes them.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.config import KSVDConfig
from lyssandra_tpu_torch.ops.dictionaries import (
    init_dictionary,
    normalize_atoms,
    replacement_atoms,
)
from lyssandra_tpu_torch.parallel.mesh import mesh_device
from lyssandra_tpu_torch.solvers.encoder import SparseEncoder
from lyssandra_tpu_torch.solvers.greedy import GreedyResult
from lyssandra_tpu_torch.utils.profiling import span, spanned


def _block_size(K: int, atom_block: int) -> int:
    """The largest divisor of K that is at most ``atom_block`` (>= 1)."""
    B = max(1, min(atom_block, K))
    while K % B:
        B -= 1
    return B


def _power_update(R, Db, Gk, on, n_power):
    """New atoms Dn (p, B) and code rows Gn (B, N) of one atom block.

    R (p, N) residual, Db (p, B) the block's atoms, Gk (B, N) their code
    rows, ``on`` (B, N) their supports (Gk != 0).  Runs ``n_power`` power
    steps of the rank-1 approximation of each E_k from g = gamma_k.  The
    reference's g o m equals g bit for bit here (g is zero off the support
    in the first step and masked in every later one), so the mask enters
    only E_k^T d.  An atom without users keeps its atom and row."""
    m = on.to(R.dtype)
    Gt = Gk
    for _ in range(n_power):
        Dn = torch.addmm(Db * (Gk * Gt).sum(dim=1)[None, :], R, Gt.T)
        Dn = Dn / torch.linalg.vector_norm(Dn, dim=0, keepdim=True) \
            .clamp_min(1e-12)
        Gt = m * torch.addmm(Gk * (Db * Dn).sum(dim=0)[:, None], Dn.T, R)
    ok = on.any(dim=1)
    return torch.where(ok[None, :], Dn, Db), torch.where(ok[:, None], Gt, Gk)


def ksvd_atom_update(X, D, Gamma, exact: bool = False, svd_iters: int = 3,
                     atom_block: int = 1):
    """One Gauss-Seidel sweep of K-SVD atom updates (residual form).

    X (p, N), D (p, K), Gamma (K, N) dense codes, tensors on one device.
    Returns new (D, Gamma); the inputs are not changed.  Matches
    oracle.ksvd_atom_update (exact=False: one power step; exact=True:
    ``svd_iters`` power steps towards the rank-1 SVD).

    ``atom_block=B`` updates B consecutive atoms per step with their R
    contractions batched into (p, N) x (N, B) products: Jacobi within the
    block, Gauss-Seidel across blocks.  B shrinks to the largest divisor
    of K; B=1 is the oracle's sequential order.
    """
    K = D.shape[1]
    B = _block_size(K, atom_block)
    n_power = svd_iters if exact else 1
    D = D.clone(memory_format=torch.contiguous_format)
    Gamma = Gamma.clone(memory_format=torch.contiguous_format)
    R = X - D @ Gamma
    for k0 in range(0, K, B):
        Db = D[:, k0:k0 + B]
        Gk = Gamma[k0:k0 + B]
        Dn, Gn = _power_update(R, Db, Gk, Gk != 0, n_power)
        # restore the invariant R = X - D Gamma for the next block
        R.addmm_(Db, Gk).addmm_(Dn, Gn, alpha=-1.0)
        D[:, k0:k0 + B] = Dn
        Gamma[k0:k0 + B] = Gn
    return D, Gamma


def _merge_duplicate_slots(idx, gamma):
    """gamma with each lane's repeated selections of one atom (both slots
    nonzero) summed into the first slot and the later one zeroed, as the
    dense scatter adds them.  A near-breakdown OMP lane can pick an atom
    twice; without the merge the per-slot write-back of the compact sweep
    would write the full new row value into both slots."""
    gamma = gamma.clone()
    T = idx.shape[1]
    for t2 in range(1, T):
        for t1 in range(t2):
            same = ((idx[:, t1] == idx[:, t2])
                    & (gamma[:, t1] != 0) & (gamma[:, t2] != 0))
            gamma[:, t1] += torch.where(same, gamma[:, t2], 0.0)
            gamma[:, t2] = torch.where(same, 0.0, gamma[:, t2])
    return gamma


def _compact_residual(X, D, idx, gamma):
    """R = X - D Gamma from compact codes: T column gathers of D."""
    R = X
    for t in range(idx.shape[1]):
        R = R - D[:, idx[:, t]] * gamma[:, t][None, :]
    return R


def ksvd_atom_update_compact(X, D, idx, gamma, exact: bool = False,
                             svd_iters: int = 3, atom_block: int = 8):
    """K-SVD atom sweep over compact codes idx/gamma (N, T): the dense
    (K, N) Gamma is never built.

    The math of :func:`ksvd_atom_update`, with each block's code rows
    scattered from the triplets and the new values gathered back into
    their slots (block-Jacobi within ``atom_block`` atoms; supports kept).
    Returns (D, gamma, nusers): gamma (N, T) updated in the original
    (n, t) slots, nusers (K,) the per-atom user counts from the support
    masks.  Slots with gamma == 0 (padding after a lane stopped) are never
    written.  The inputs are not changed.
    """
    K = D.shape[1]
    N = idx.shape[0]
    B = _block_size(K, atom_block)
    n_power = svd_iters if exact else 1
    D = D.clone()
    idx = idx.long()
    gamma = _merge_duplicate_slots(idx, gamma)
    R = _compact_residual(X, D, idx, gamma)
    lanes = torch.arange(N, device=X.device)[:, None]
    nusers = torch.empty((K,), dtype=X.dtype, device=X.device)
    for k0 in range(0, K, B):
        rel = idx - k0
        inb = (rel >= 0) & (rel < B)
        # the block's code rows; slots of other atoms add into a spare row
        Gk = torch.zeros((B + 1) * N, dtype=X.dtype, device=X.device)
        Gk.scatter_add_(0, (torch.where(inb, rel, B) * N + lanes).view(-1),
                        gamma.reshape(-1))
        Gk = Gk.view(B + 1, N)[:B]
        on = Gk != 0
        nusers[k0:k0 + B] = on.sum(dim=1)
        Db = D[:, k0:k0 + B]
        Dn, Gn = _power_update(R, Db, Gk, on, n_power)
        R.addmm_(Db, Gk).addmm_(Dn, Gn, alpha=-1.0)
        D[:, k0:k0 + B] = Dn
        val = Gn.T.gather(1, torch.where(inb, rel, 0))
        gamma = torch.where(inb & (gamma != 0), val, gamma)
    return D, gamma, nusers


def _stats_to_metrics(vals) -> dict[str, Any]:
    """Host metrics from one iteration's stats [objective, rmse, avg_nnz,
    atoms_replaced, objective_coding].  The sweep phase is monotone
    (objective <= objective_coding); the coding step is not: greedy OMP
    recodes from scratch, so the trace across iterations may tick up
    near convergence."""
    out = dict(
        objective=float(vals[0]), rmse=float(vals[1]),
        avg_nnz=float(vals[2]), atoms_replaced=int(vals[3]),
    )
    if len(vals) > 4:
        out["objective_coding"] = float(vals[4])
    return out


def _ksvd_compact_post(X, D, idx, gamma, code_err, *, exact, svd_iters,
                       atom_block, replace_dead, min_use, max_coherence):
    """The post-coding tail of a compact K-SVD iteration: atom sweep,
    stats, dead-atom replacement, normalization, all on compact codes.
    Returns (D, gamma, err (N,), stats (5,))."""
    with span("lyssa.ksvd.sweep"):
        D, gamma, nusers = ksvd_atom_update_compact(
            X, D, idx, gamma, exact=exact, svd_iters=svd_iters,
            atom_block=atom_block)
    with span("lyssa.ksvd.post"):
        R = _compact_residual(X, D, idx.long(), gamma)
        RR = R * R
        err = RR.sum(dim=0)
        stats = [err.sum(), torch.sqrt(RR.mean()),
                 (gamma != 0).sum(dim=1).to(X.dtype).mean()]
        if replace_dead:
            D, bad = replacement_atoms(X, D, err, nusers, min_use,
                                       max_coherence)
            gamma = torch.where(bad[idx.long()], 0.0, gamma)
            stats.append(bad.sum().to(X.dtype))
        else:
            stats.append(torch.zeros((), dtype=X.dtype, device=X.device))
        stats.append(code_err.sum())          # post-coding objective
        return normalize_atoms(D), gamma, err, torch.stack(stats)


@spanned("lyssa.ksvd.post")
def _ksvd_dense_post(X, D, Gamma, obj_code, cfg: KSVDConfig):
    """The tail of a dense K-SVD iteration after the sweep: stats of the
    post-sweep model, dead-atom replacement (the replaced atoms' code rows
    zeroed, in place), normalization.  Returns (D, Gamma, stats (5,))."""
    R = X - D @ Gamma
    err = (R * R).sum(dim=0)
    on = Gamma.abs() > 0
    stats = [err.sum(), torch.sqrt((R * R).mean()),
             on.sum(dim=0).to(X.dtype).mean()]
    if cfg.replace_dead:
        D, bad = replacement_atoms(X, D, err, on.sum(dim=1), cfg.min_use,
                                   cfg.max_coherence)
        Gamma.masked_fill_(bad[:, None], 0.0)
        stats.append(bad.sum().to(X.dtype))
    else:
        stats.append(torch.zeros((), dtype=X.dtype, device=X.device))
    stats.append(obj_code)
    return normalize_atoms(D), Gamma, torch.stack(stats)


def ksvd_step_compact(X, D, encoder: SparseEncoder, cfg: KSVDConfig):
    """One K-SVD iteration on compact codes: no (K, N) Gamma anywhere.

    Returns (D, GreedyResult codes, device stats).  The sweep runs at
    ``max(cfg.atom_block, 8)`` atoms a block."""
    res = encoder.encode(X, D, dense=False)
    D, gamma, err, stats = _ksvd_compact_post(
        X, D, res.idx, res.gamma, res.err,
        exact=cfg.exact_svd, svd_iters=cfg.svd_iters,
        atom_block=max(cfg.atom_block, 8),
        replace_dead=cfg.replace_dead, min_use=cfg.min_use,
        max_coherence=cfg.max_coherence)
    return D, GreedyResult(res.idx, gamma, err, res.nsel), stats


def ksvd_step(X, D, encoder: SparseEncoder, cfg: KSVDConfig):
    """One full K-SVD iteration: code, update atoms, replace dead atoms.

    Returns (D, Gamma, stats) with stats a device tensor [objective, rmse,
    avg_nnz, atoms_replaced, objective_coding].  The metrics describe the
    post-sweep model before replacement: replaced atoms get code rows only
    at the next coding step."""
    Gamma = encoder.encode(X, D)
    Rc = X - D @ Gamma
    obj_code = (Rc * Rc).sum()
    with span("lyssa.ksvd.sweep"):
        D, Gamma = ksvd_atom_update(
            X, D, Gamma, exact=cfg.exact_svd, svd_iters=cfg.svd_iters,
            atom_block=cfg.atom_block)
    return _ksvd_dense_post(X, D, Gamma, obj_code, cfg)


class KSVDLearner:
    """Reference-mirroring `ksvd` class: ``fit(X) -> self`` with the learned
    ``D_`` (p, K) and the final codes ``Gamma_``.

    Per-iteration metrics (objective, rmse, nnz, atoms replaced, patches/s)
    are collected in ``history_``.  With ``cfg.codes`` 'compact' (or 'auto'
    when a dense Gamma would exceed 1 GiB and the encoder's route returns
    compact codes) the fit runs on idx/gamma (N, T) codes and ``Gamma_`` is
    a :class:`~lyssandra_tpu_torch.solvers.greedy.GreedyResult`.

    ``device``: where the fit runs (default: where X lies if it is a
    tensor, else the GPU; see ``_device.resolve_device``); handed to the
    default encoder.  ``mesh`` (``parallel.Mesh``): the default encoder
    splits each coding block over the mesh's data slots, and the atom sweep
    runs on the first slot, where X, D and the gathered codes lie (see
    ``parallel.mesh``); a ``device`` other than the first slot's raises.
    """

    def __init__(self, cfg: KSVDConfig = KSVDConfig(), *,
                 encoder: SparseEncoder | None = None, verbose: bool = False,
                 callback: Callable[[int, dict], None] | None = None,
                 workspace=None, checkpoint_every: int = 5, mesh=None,
                 device=None):
        if mesh is not None:
            device = mesh_device(mesh, device)
        self.cfg = cfg
        self.device = device
        self.encoder = encoder or SparseEncoder(
            "bomp", {"T": cfg.T}, check_atoms=False, mesh=mesh,
            device=device)
        self.verbose = verbose
        self.callback = callback
        self.workspace = workspace           # utils.Workspace for resume
        self.checkpoint_every = checkpoint_every
        self.history_: list[dict[str, Any]] = []

    @spanned("lyssa.ksvd.fit")
    def fit(self, X, D0=None, n_iter: int | None = None,
            resume: bool = False) -> "KSVDLearner":
        """Learn ``D_`` from X (p, N).  The fit is the span
        ``lyssa.ksvd.fit``, each iteration with its metrics
        ``lyssa.ksvd.iteration``, inside which the coding is
        ``lyssa.encode`` and the step's sweep and post-sweep tail
        ``lyssa.ksvd.sweep`` and ``lyssa.ksvd.post`` (``utils.profiling``).
        """
        device = resolve_device(self.device, X, D0)
        X = torch.as_tensor(X, dtype=torch.float32, device=device)
        cfg = self.cfg
        D = (torch.as_tensor(D0, dtype=torch.float32, device=device).clone()
             if D0 is not None
             else init_dictionary(X, cfg.K, cfg.init, cfg.seed,
                                  device=device))
        start = 0
        if resume and self.workspace is not None:
            step, state = self.workspace.load_latest_state(
                {"D": D, "iter": torch.zeros((), dtype=torch.int32)})
            if step is not None:
                D = state["D"].to(device)
                start = int(state["iter"]) + 1
        total = n_iter if n_iter is not None else cfg.n_iter
        Gamma = None
        # a per-iteration host consumer (verbose print, callback, metrics
        # log) needs each iteration's stats on the host; otherwise they stay
        # on the device and one stacked fetch at the end covers the fit
        eager_metrics = (self.verbose or self.callback is not None
                         or self.workspace is not None)
        compact = cfg.codes == "compact" or (
            cfg.codes == "auto"
            and 4 * cfg.K * X.shape[1] > (1 << 30)
            and self.encoder.algorithm in SparseEncoder._COMPACT)
        step_fn = ksvd_step_compact if compact else ksvd_step
        pending: list[tuple[int, torch.Tensor, float]] = []
        t_fit0 = time.perf_counter()
        for it in range(start, total):
            with span("lyssa.ksvd.iteration"):
                t0 = time.perf_counter()
                D, Gamma, stats = step_fn(X, D, self.encoder, cfg)
                if eager_metrics:
                    metrics = _stats_to_metrics(stats.cpu().numpy())
                    metrics["seconds"] = time.perf_counter() - t0
                    metrics["patches_per_sec"] = (X.shape[1]
                                                  / metrics["seconds"])
                    metrics["iter"] = it
                    self.history_.append(metrics)
                    if self.verbose:
                        print(f"[ksvd it {it}] {metrics}")
                    if self.callback is not None:
                        self.callback(it, metrics)
                    if self.workspace is not None:
                        self.workspace.log_metrics(metrics)
                        if (it + 1) % self.checkpoint_every == 0 \
                                or it == total - 1:
                            self.workspace.save_state(it, {
                                "D": D,
                                "iter": torch.tensor(it, dtype=torch.int32)})
                else:
                    pending.append((it, stats, time.perf_counter() - t0))
        if Gamma is None:                     # fully resumed: re-code once
            Gamma = self.encoder.encode(X, D, dense=not compact)
        if pending:
            all_vals = torch.stack([s for _, s, _ in pending]).cpu().numpy()
            t_wall = time.perf_counter() - t_fit0
            for (it, _, dt), vals in zip(pending, all_vals):
                metrics = _stats_to_metrics(vals)
                # without a per-iteration sync the loop only enqueues work:
                # record the amortized wall rate, and the enqueue time apart
                metrics["seconds"] = t_wall / len(pending)
                metrics["dispatch_seconds"] = dt
                metrics["patches_per_sec"] = (
                    X.shape[1] * len(pending) / t_wall)
                metrics["iter"] = it
                self.history_.append(metrics)
        self.D_ = D
        self.Gamma_ = Gamma
        return self

    def encode(self, X, *, dense: bool = True):
        """Codes of X over the learned dictionary (dense Gamma (K, N), or a
        compact GreedyResult with dense=False on greedy routes)."""
        return self.encoder.encode(
            torch.as_tensor(X, dtype=torch.float32, device=self.D_.device),
            self.D_, dense=dense)


ksvd = KSVDLearner  # reference-style lowercase alias
