"""Online dictionary learning (Mairal, Bach, Ponce, Sapiro 2009) —
``lyssandra_tpu.dict_learning.online`` counterpart.

Each step lasso-codes a minibatch (feature-sign by default, FISTA
optionally), accumulates the sufficient statistics

    A <- beta A + Gamma Gamma^T        (K, K)
    B <- beta B + X Gamma^T            (p, K)

and runs ``n_sweeps`` Gauss-Seidel sweeps of block-coordinate descent over
the atoms, in order:

    d_k <- proj_{||.||<=1}( d_k + (b_k - D a_k) / A_kk ).

``fit`` streams minibatches in chunks of ``chunk_batches``; a chunk is one
metrics record and one checkpoint.  Its in-loop coder is
``feature_sign_scan`` (the plain loop: no kernel), ``partial_fit`` and
``online_dl_step`` code through ``feature_sign``, which on a GPU starts from
the fused cold-start kernel (``ops/cuda_fs.py``).  The atom sweep and the
statistics never read a value on the host.

With a ``mesh`` (``parallel.Mesh``), ``fit`` splits each minibatch's lanes
over the data slots and codes each split on its slot; Gamma Gamma^T and
X Gamma^T are summed from the slots' partial products on the first slot,
in slot order, and the atom sweep runs there.  ``partial_fit`` codes on the
first slot alone, as the reference's runs unsharded.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.config import OnlineDLConfig
from lyssandra_tpu_torch.ops.dictionaries import init_dictionary
from lyssandra_tpu_torch.parallel.collectives import slot_sum
from lyssandra_tpu_torch.parallel.mesh import (
    map_data,
    mesh_device,
    row_copies,
)
from lyssandra_tpu_torch.solvers.lasso import (
    _fista_body,
    feature_sign,
    feature_sign_scan,
    fista,
)


class OnlineDLState(NamedTuple):
    D: torch.Tensor      # (p, K)
    A: torch.Tensor      # (K, K)  sum of Gamma Gamma^T
    B: torch.Tensor      # (p, K)  sum of X Gamma^T
    step: torch.Tensor   # () int32 minibatches seen, on the CPU (a counter
    #                      the host keeps, so reading it never syncs)


def _dict_update_body(D, A, B, n_sweeps: int):
    """``n_sweeps`` sweeps of atom updates over k = 0..K-1 in order, each
    seeing the atoms before it; an atom with A_kk < 1e-10 (no use yet)
    keeps its value.  Returns a new D; the inputs are not changed."""
    D = D.clone()
    K = D.shape[1]
    akk = torch.diagonal(A)
    dead = akk < 1e-10
    akk = akk.clamp_min(1e-10)
    for _ in range(n_sweeps):
        for k in range(K):
            dk = D[:, k]
            u = dk + torch.addmv(B[:, k], D, A[:, k], alpha=-1.0) / akk[k]
            u = u / torch.linalg.vector_norm(u).clamp_min(1.0)
            D[:, k] = torch.where(dead[k], dk, u)
    return D


def _code_batch(D, Xb, lam, coder: str, fs_opts: dict,
                code_blocks: int = 1):
    if coder == "feature_sign":
        cb = code_blocks
        if cb > 1 and Xb.shape[1] % cb == 0:
            # cb sub-blocks one after another: each feature-sign loop ends
            # with its own slowest lane.  Lanes are independent, so the
            # codes are the same as one call's
            bs = Xb.shape[1] // cb
            return torch.cat([
                feature_sign_scan(D, Xb[:, i * bs:(i + 1) * bs], lam,
                                  **fs_opts)
                for i in range(cb)], dim=1)
        return feature_sign_scan(D, Xb, lam, **fs_opts)
    if coder == "fista":
        g0 = torch.zeros((D.shape[1], Xb.shape[1]), dtype=D.dtype,
                         device=D.device)
        return _fista_body(D, Xb, D.T @ Xb, lam, g0, n_iter=300)
    raise ValueError(coder)


def _code_stats(D, Xb, lam, coder, fs_opts, code_blocks, mesh=None):
    """A minibatch's codes and statistics: (Gamma, Gamma Gamma^T,
    X Gamma^T), on D's device.  With a mesh the lanes are coded per data
    slot, and the statistics summed from the slots' partials in slot
    order."""
    if mesh is None:
        Gamma = _code_batch(D, Xb, lam, coder, fs_opts, code_blocks)
        return Gamma, Gamma @ Gamma.T, Xb @ Gamma.T
    def stats(d, x):
        g = _code_batch(d, x, lam, coder, fs_opts, code_blocks)
        return g, g @ g.T, x @ g.T

    G, GG, XG = zip(*map_data(stats, row_copies(D, mesh), Xb, mesh))
    return (torch.cat(G, dim=1), slot_sum(GG, D.device),
            slot_sum(XG, D.device))


def _online_chunk(
    D, A, B, Xc, lam, beta,
    *, n_sweeps, coder, max_active, max_iter, max_inner, code_blocks=1,
    warm_start=0, cold_unroll=0, mesh=None,
):
    """The Mairal update over a chunk of minibatches, Xc (nb, p, bs), one
    after another.  Returns (D, A, B, objs, nnzs): objs and nnzs (nb,) are
    each minibatch's post-update objective and mean nnz, on the device
    (nothing here reads a value on the host beyond the coder's own loop
    exits).  ``mesh``: code each minibatch per data slot
    (``_code_stats``)."""
    fs_opts = dict(
        max_active=max_active, max_iter=max_iter, max_inner=max_inner,
        warm_start=warm_start, cold_unroll=cold_unroll,
    )
    objs, nnzs = [], []
    for Xb in Xc:
        Gamma, GG, XG = _code_stats(D, Xb, lam, coder, fs_opts, code_blocks,
                                    mesh)
        A = beta * A + GG
        B = beta * B + XG
        D = _dict_update_body(D, A, B, n_sweeps)
        R = Xb - D @ Gamma
        objs.append((R * R).sum() + lam * Gamma.abs().sum())
        nnzs.append((Gamma.abs() > 1e-10).sum(dim=0).to(D.dtype).mean())
    return D, A, B, torch.stack(objs), torch.stack(nnzs)


def holdout_objective(D, Xh, lam, n_iter: int = 300) -> torch.Tensor:
    """Lasso objective per signal of a fixed set, FISTA-coded: a
    convergence metric comparable across minibatches (a 0-d tensor)."""
    g0 = torch.zeros((D.shape[1], Xh.shape[1]), dtype=D.dtype,
                     device=D.device)
    G = _fista_body(D, Xh, D.T @ Xh, float(lam), g0, n_iter=n_iter)
    R = Xh - D @ G
    return ((R * R).sum() + lam * G.abs().sum()) / Xh.shape[1]


def online_dl_step(
    state: OnlineDLState, Xb, cfg: OnlineDLConfig,
    *, coder: str = "feature_sign",
) -> tuple[OnlineDLState, torch.Tensor]:
    """One minibatch step; returns (new state, minibatch codes).  Xb goes
    to the state's device."""
    Xb = torch.as_tensor(Xb, dtype=torch.float32, device=state.D.device)
    if coder == "feature_sign":
        Gamma = feature_sign(state.D, Xb, cfg.lam)
    elif coder == "fista":
        Gamma = fista(state.D, Xb, cfg.lam)
    else:
        raise ValueError(coder)
    A = cfg.beta * state.A + Gamma @ Gamma.T
    B = cfg.beta * state.B + Xb @ Gamma.T
    D = _dict_update_body(state.D, A, B, cfg.n_sweeps)
    return OnlineDLState(D, A, B, state.step + 1), Gamma


class OnlineDictionaryLearner:
    """Reference-mirroring online learner with ``partial_fit``.

    ``partial_fit(Xb)`` consumes one minibatch; ``fit(X, n_epochs)``
    streams minibatches from X in chunks.  ``state`` is an
    :class:`OnlineDLState` (checkpointable).  ``device``: where the
    learner runs (default: where the first data tensor lies, else the GPU;
    see ``_device.resolve_device``).  ``mesh`` (``parallel.Mesh``): ``fit``
    codes each minibatch per data slot and learns on the first slot; a
    ``device`` other than the first slot's raises.
    """

    def __init__(
        self, cfg: OnlineDLConfig = OnlineDLConfig(), *,
        coder: str = "feature_sign", verbose: bool = False, mesh=None,
        device=None,
    ):
        if mesh is not None:
            device = mesh_device(mesh, device)
        self.mesh = mesh
        self.cfg = cfg
        self.coder = coder
        self.verbose = verbose
        self.device = device
        self.state: OnlineDLState | None = None
        self.history_: list[dict[str, Any]] = []

    def _resolve_cold_unroll(self) -> int:
        """fs_cold_unroll=None -> 0, as in the reference (whose choice
        rests on a TPU measurement; on a GPU it is an open question)."""
        cu = self.cfg.fs_cold_unroll
        return 0 if cu is None else int(cu)

    def _device_for(self, *inputs) -> torch.device:
        if self.state is not None:
            return self.state.D.device
        return resolve_device(self.device, *inputs)

    def _init_state(self, Xb) -> OnlineDLState:
        p = Xb.shape[0]
        K = self.cfg.K
        D = init_dictionary(Xb, K, "data", self.cfg.seed)
        dev = D.device
        return OnlineDLState(
            D, torch.zeros((K, K), dtype=torch.float32, device=dev),
            torch.zeros((p, K), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int32))

    def partial_fit(self, Xb) -> "OnlineDictionaryLearner":
        Xb = torch.as_tensor(Xb, dtype=torch.float32,
                             device=self._device_for(Xb))
        if self.state is None:
            self.state = self._init_state(Xb)
        self.state, Gamma = online_dl_step(self.state, Xb, self.cfg,
                                           coder=self.coder)
        R = Xb - self.state.D @ Gamma
        stats = torch.stack([
            (R * R).sum() + self.cfg.lam * Gamma.abs().sum(),
            (Gamma.abs() > 1e-10).sum(dim=0).to(R.dtype).mean()]).cpu()
        m = dict(step=int(self.state.step),
                 batch_objective=float(stats[0]), avg_nnz=float(stats[1]))
        self.history_.append(m)
        if self.verbose:
            print(f"[online-dl] {m}")
        return self

    def fit(self, X, n_epochs: int = 1, seed: int = 0,
            holdout=None, *, workspace=None, resume: bool = False,
            checkpoint_every: int = 1) -> "OnlineDictionaryLearner":
        """Stream minibatches of X (p, N) in chunks of ``chunk_batches``.

        The stream is the reference's: ``np.random.default_rng(seed)``
        draws one permutation of the N columns per epoch, so both packages
        see the same minibatches.  X moves to the device once; each chunk
        gathers its columns there.

        holdout: optional (p, Nh) fixed signal set; its lasso objective is
        recorded after every chunk in ``history_`` (``holdout_objective``).

        workspace: optional ``utils.Workspace``; the state and the stream
        position (epoch, chunk) are checkpointed every ``checkpoint_every``
        chunks and after the last.  ``resume=True`` reloads the newest
        checkpoint and continues the same stream (the permutations are
        replayed from ``seed``).
        """
        dev = self._device_for(X, holdout)
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        p, N = X.shape
        cfg = self.cfg
        bs = cfg.batch_size
        cb = cfg.chunk_batches
        nb_total = N // bs
        if nb_total == 0:
            raise ValueError(f"need >= batch_size={bs} signals, got {N}")
        n_chunks = (nb_total + cb - 1) // cb
        Xh = None if holdout is None else torch.as_tensor(
            holdout, dtype=torch.float32, device=dev)
        start_epoch, start_chunk = 0, 0
        if resume and workspace is not None:
            K = cfg.K
            counter = torch.zeros((), dtype=torch.int32)
            tmpl = {
                "D": torch.zeros((p, K), device=dev),
                "A": torch.zeros((K, K), device=dev),
                "B": torch.zeros((p, K), device=dev),
                "step": counter, "epoch": counter, "chunk": counter,
            }
            ck_step, st = workspace.load_latest_state(tmpl)
            if ck_step is not None:
                self.state = OnlineDLState(st["D"], st["A"], st["B"],
                                           st["step"])
                start_epoch = int(st["epoch"])
                start_chunk = int(st["chunk"]) + 1
                if start_chunk >= n_chunks:
                    start_epoch += 1
                    start_chunk = 0
        rng = np.random.default_rng(seed)
        # replay the permutations up to the resume point, so the continued
        # run sees the same minibatch order
        for _ in range(start_epoch):
            rng.permutation(N)
        for epoch in range(start_epoch, n_epochs):
            perm = rng.permutation(N)
            if self.state is None:
                # init from the first minibatch of the stream, so a fit()
                # equals the same-order partial_fit sequence
                self.state = self._init_state(
                    X[:, torch.from_numpy(perm[:bs]).to(dev)])
            chunk_i = -1
            for s in range(0, nb_total, cb):
                chunk_i += 1
                if epoch == start_epoch and chunk_i < start_chunk:
                    continue
                nb = min(cb, nb_total - s)
                cols = torch.from_numpy(perm[s * bs:(s + nb) * bs]).to(dev)
                Xc = X[:, cols].reshape(p, nb, bs).permute(1, 0, 2)
                t0 = time.perf_counter()
                D, A, B, objs, nnzs = _online_chunk(
                    self.state.D, self.state.A, self.state.B, Xc,
                    cfg.lam, cfg.beta,
                    n_sweeps=cfg.n_sweeps, coder=self.coder,
                    max_active=cfg.fs_max_active, max_iter=cfg.fs_max_iter,
                    max_inner=cfg.fs_max_inner, code_blocks=cfg.code_blocks,
                    warm_start=cfg.fs_warm_start,
                    cold_unroll=self._resolve_cold_unroll(), mesh=self.mesh,
                )
                stats = [objs[-1], nnzs[-1]]
                if Xh is not None:
                    stats.append(holdout_objective(D, Xh, cfg.lam))
                stats = torch.stack(stats).cpu().numpy()   # one host read
                m = dict(step=int(self.state.step) + nb,
                         batch_objective=float(stats[0]),
                         avg_nnz=float(stats[1]))
                if Xh is not None:
                    m["holdout_objective"] = float(stats[2])
                m["seconds"] = time.perf_counter() - t0
                m["patches_per_sec"] = nb * bs / m["seconds"]
                self.state = OnlineDLState(D, A, B, self.state.step + nb)
                self.history_.append(m)
                if self.verbose:
                    print(f"[online-dl] {m}")
                if workspace is not None and (
                        chunk_i % checkpoint_every == 0
                        or chunk_i == n_chunks - 1):
                    workspace.log_metrics(m)
                    workspace.save_state(
                        epoch * n_chunks + chunk_i,
                        {"D": D, "A": A, "B": B,
                         "step": self.state.step.clone(),
                         "epoch": torch.tensor(epoch, dtype=torch.int32),
                         "chunk": torch.tensor(chunk_i, dtype=torch.int32)})
        return self

    @property
    def D_(self):
        return self.state.D
