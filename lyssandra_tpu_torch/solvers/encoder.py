"""`SparseEncoder` front end: algorithm name + params -> batched solver
(``lyssandra_tpu.solvers.encoder`` counterpart).

Validates atom norms, chunks the signal matrix into fixed-size blocks
(the last one zero-padded) and codes the blocks one after another on one
device.  Every route of the reference is ported: ``bomp``/``batch_omp``,
``omp``, ``group_omp``, ``nn_omp``, the thresholding coders,
``lasso``/``feature_sign``/``fss`` (feature-sign search),
``lars``/``lasso_lars`` (the LARS-lasso homotopy), ``fista`` and ``llc``.

With a ``mesh`` (``lyssandra_tpu_torch.parallel``), the routes whose solve
runs without host-side loops (the reference's ``_TRACEABLE``) split each
block's columns over the data slots: the solver runs once per slot on that
slot's device, with D replicated once per ``encode``, and the results are
concatenated on the first slot in slot order.  Lasso and LARS drive host
loops that end with the block's slowest lane, so they code each whole
block on the first slot, keeping their whole-block trip counts.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.parallel.mesh import (
    map_data,
    mesh_device,
    row_copies,
)
from lyssandra_tpu_torch.solvers import greedy
from lyssandra_tpu_torch.solvers.lasso import feature_sign, fista, lars
from lyssandra_tpu_torch.solvers.llc import llc
from lyssandra_tpu_torch.utils.profiling import span, spanned

_THRESHOLDING = ("thresholding", "soft_thresholding", "hard_thresholding")
_CONVEX = ("lasso", "feature_sign", "fss", "lars", "lasso_lars")


class SparseEncoder:
    """Encode signal columns into sparse codes over a fixed dictionary.

    algorithm: 'omp' | 'bomp' (batch_omp) | 'group_omp' | 'nn_omp'
               | 'thresholding' ('soft_thresholding', 'hard_thresholding')
               | 'lasso' ('feature_sign', 'fss': feature-sign search)
               | 'lars' ('lasso_lars': LARS-lasso homotopy)
               | 'fista' | 'llc' (locality-constrained coding)
    params: algorithm kwargs (T, eps, lam, groups, kind, ...).
    block:  signals per solver call; longer inputs are coded in blocks of
            this size, the last one zero-padded.  Default 16384 for greedy
            routes, 2048 for convex ones (the reference's defaults, tuned
            on a TPU).
    mesh:   optional ``parallel.Mesh``: blocks split over its data slots
            (see above); results come back on its first slot.
    device: where D and X go (default: where the first tensor input lies,
            else the GPU; see ``_device.resolve_device``).  With a mesh,
            the mesh decides, and a device other than its first slot's
            raises ValueError.
    """

    def __init__(
        self,
        algorithm: str = "bomp",
        params: dict[str, Any] | None = None,
        *,
        block: int | None = None,
        mesh=None,
        check_atoms: bool = True,
        device=None,
    ):
        if mesh is not None:
            device = mesh_device(mesh, device)
        self.algorithm = algorithm
        self.params = dict(params or {})
        if block is None:
            block = 2048 if algorithm in _CONVEX else 16384
        self.block = block
        self.check_atoms = check_atoms
        self.mesh = mesh
        self.device = device

    # -- internals ---------------------------------------------------------

    def _solver(self):
        alg = self.algorithm
        if alg in ("bomp", "batch_omp"):
            return greedy.batch_omp
        if alg == "omp":
            return greedy.omp
        if alg == "group_omp":
            return greedy.group_omp
        if alg == "nn_omp":
            return greedy.nn_omp
        if alg in _THRESHOLDING:
            kind = "hard" if alg == "hard_thresholding" else self.params.get(
                "kind", "soft")
            return lambda D, X, **kw: greedy.threshold_code(
                D, X, self.params["lam"], kind)
        if alg in ("lasso", "feature_sign", "fss"):
            return feature_sign
        if alg in ("lars", "lasso_lars"):
            return lars
        if alg == "fista":
            return fista
        if alg == "llc":
            return llc
        raise ValueError(f"unknown algorithm: {self.algorithm}")

    def _solver_kwargs(self):
        if self.algorithm in _THRESHOLDING:
            return {}
        kw = dict(self.params)
        kw.pop("kind", None)
        return kw

    # routes whose solve runs without host-side loops, so a block's columns
    # can split over the data slots (the reference's _TRACEABLE)
    _TRACEABLE = ("bomp", "batch_omp", "omp", "group_omp", "nn_omp",
                  *_THRESHOLDING, "llc", "fista")

    # greedy routes whose solvers return a compact GreedyResult when asked
    # (group_omp's compact slots are T * group_size wide)
    _COMPACT = ("bomp", "batch_omp", "omp", "nn_omp", "group_omp")

    # -- public API --------------------------------------------------------

    @spanned("lyssa.encode")
    def encode(self, X, D, *, dense: bool = True):
        """Encode X (p, N) over D (p, K).

        dense=True: dense code matrix Gamma (K, N).
        dense=False (greedy routes only): compact GreedyResult with
        idx/gamma (N, T), without the (K, N) scatter.

        The call is the span ``lyssa.encode``, each block's solver call the
        span ``lyssa.encode.block`` (``utils.profiling``).
        """
        if not dense and self.algorithm not in self._COMPACT:
            raise ValueError(
                f"dense=False needs a greedy route {self._COMPACT}, "
                f"got {self.algorithm!r}")
        device = resolve_device(self.device, D, X)
        D = greedy._as_f32(D, device)
        if self.check_atoms:
            nrm = torch.linalg.norm(D, dim=0)
            if not torch.allclose(nrm, torch.ones_like(nrm), atol=1e-3):
                raise ValueError(
                    "dictionary atoms must be unit-norm (got norms in "
                    f"[{float(nrm.min()):.4f}, {float(nrm.max()):.4f}])")
        X = greedy._as_f32(X, device)
        N = X.shape[1]
        solver = self._solver()
        kw = self._solver_kwargs()
        if not dense:
            kw["dense"] = False
        if self.mesh is not None and self.algorithm in self._TRACEABLE:
            # each block over the data slots, the pieces joined on the
            # first slot in slot order
            Ds = row_copies(D, self.mesh)

            def call(Xb):
                with span("lyssa.encode.block"):
                    outs = map_data(lambda d, x: solver(d, x, **kw), Ds, Xb,
                                    self.mesh)
                    return (torch.cat(outs, dim=1) if dense
                            else greedy.GreedyResult.concatenate(outs))
        else:
            def call(Xb):
                with span("lyssa.encode.block"):
                    return solver(D, Xb, **kw)
        if N <= self.block:
            return call(X)

        # pad to full blocks so every call sees the same shape
        nblocks = math.ceil(N / self.block)
        Xp = torch.nn.functional.pad(X, (0, nblocks * self.block - N))
        outs = [call(Xp[:, b * self.block:(b + 1) * self.block])
                for b in range(nblocks)]
        if not dense:
            res = greedy.GreedyResult.concatenate(outs)
            return greedy.GreedyResult(*(a[:N] for a in res))
        return torch.cat(outs, dim=1)[:, :N]


def sparse_encoder(algorithm: str = "bomp", params: dict | None = None,
                   **kw) -> SparseEncoder:
    """Reference-style constructor alias."""
    return SparseEncoder(algorithm, params, **kw)
