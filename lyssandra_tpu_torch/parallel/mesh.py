"""Device mesh (``lyssandra_tpu.parallel.mesh`` counterpart): a
single-controller mesh of device slots.

The reference's mesh is JAX's: one process sees every device, the caller
hands global arrays to the usual entry points and gets global results
back.  This is its PyTorch counterpart.  A :class:`Mesh` is a
('data', 'model') grid of device *slots*; a slot names a ``torch.device``,
and several slots may name the same one: eight ``cpu`` slots stand in for
XLA's eight virtual CPU devices, and several ``cuda:0`` slots run the split
and the collectives on one GPU.  On several GPUs nothing changes.  The one
process dispatches each slot's work in turn without waiting for any of it;
the cross-slot operations are explicit tensor moves
(``parallel.collectives``).

'data' splits the patch axis.  Coding is lane-independent, so each data
row codes its shard with the dictionary replicated, and nothing crosses
between slots until the results are gathered on the first slot.  Only a
row's first slot codes: the reference runs the same shard redundantly on
every 'model' device of the row.  'model' splits the atom axis for
dictionaries too large for one slot (``parallel.model_sharded``).

K-SVD (``sharded_ksvd_step``, ``KSVDLearner(mesh=)``) codes per data slot
(or through ``omp_model_sharded``) and then runs the atom sweep on the
gathered X and Gamma on the first slot, not as per-shard partial sums.
The sweep is K strictly sequential launch-bound steps (on an H100 the
device sat idle 92% of a config-2 iteration, PERF.md); split over slots it
would multiply its launches by the number of devices and add a cross-device
reduction per atom, while gathered it is the same arithmetic as without a
mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.parallel.collectives import broadcast, gather_to
from lyssandra_tpu_torch.solvers import greedy

AXES = ("data", "model")


def _slot_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ('data', 'model') grid of device slots.

    devices: (data, model) numpy object array of ``torch.device``; slots
    may name the same device.  ``shape`` is ``{"data": d, "model": m}``.
    """

    axis_names = AXES

    def __init__(self, devices):
        devs = np.asarray(devices, dtype=object)
        if devs.ndim != 2 or devs.size == 0:
            raise ValueError(
                f"a mesh is a non-empty (data, model) grid of devices, got "
                f"shape {devs.shape}")
        self.devices = np.empty(devs.shape, dtype=object)
        for ij, d in np.ndenumerate(devs):
            self.devices[ij] = _slot_device(d)

    @property
    def shape(self) -> dict[str, int]:
        d, m = self.devices.shape
        return {"data": d, "model": m}

    @property
    def first(self) -> torch.device:
        """The first slot's device, where results are gathered."""
        return self.devices[0, 0]

    def data_devices(self) -> list[torch.device]:
        """The first slot of each data row, in row order."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """Create a ('data', 'model') mesh.  data=-1: all remaining slots.

    devices: the slots, in order (devices or their names; a device may
    repeat, e.g. ``["cpu"] * 8``); default every CUDA device.  With no GPU
    and no ``devices`` it raises: there is no silent CPU mesh."""
    if devices is None:
        resolve_device()                 # raises where there is no GPU
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if model < 1 or (data != -1 and data < 1):
        raise ValueError(f"mesh axes must be >= 1: data={data}, model={model}")
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices do not split into model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"data={data} x model={model} needs more than {n} "
                         f"devices")
    flat = np.empty(n, dtype=object)
    flat[:] = [_slot_device(d) for d in devices]
    return Mesh(flat[:data * model].reshape(data, model))


def mesh_device(mesh, device=None) -> torch.device:
    """Where an entry point with ``mesh`` returns its results: the mesh's
    first slot.  A ``mesh`` that is not a :class:`Mesh` raises TypeError;
    a ``device`` other than the first slot's raises ValueError."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a lyssandra_tpu_torch.parallel.Mesh, "
                        f"got {type(mesh).__name__}")
    first = mesh.first
    if device is not None:
        d = torch.device(device)
        if d.type != first.type or (d.index is not None and d != first):
            raise ValueError(f"device={device!r} conflicts with the mesh, "
                             f"whose first slot is {first}")
    return first


def _check_spec(spec) -> tuple:
    spec = tuple(spec)
    named = [a for a in spec if a is not None]
    if any(a not in AXES for a in named) or len(set(named)) != len(named):
        raise ValueError(f"spec entries are None, 'data' or 'model', each "
                         f"axis at most once: {spec}")
    return spec


class ShardedTensor:
    """A global tensor split over a mesh: the counterpart of a
    ``jax.Array`` with a ``NamedSharding``.

    spec: one entry per leading dimension, None or a mesh axis name (the
    counterpart of ``PartitionSpec``; ``()`` is replicated).  shards: an
    object array shaped like ``mesh.devices``; ``shards[i, j]`` lies on
    ``mesh.devices[i, j]`` and is the piece of the global tensor that slot
    holds (pieces along an axis that the spec does not name repeat)."""

    def __init__(self, mesh: Mesh, spec, shards):
        self.mesh = mesh
        self.spec = _check_spec(spec)
        self.shards = shards

    def _joined(self, axis: str):
        return self.spec.index(axis) if axis in self.spec else None

    @property
    def shape(self) -> tuple[int, ...]:
        s = list(self.shards[0, 0].shape)
        dd, dm = self._joined("data"), self._joined("model")
        if dd is not None:
            s[dd] = sum(t.shape[dd] for t in self.shards[:, 0])
        if dm is not None:
            s[dm] = sum(t.shape[dm] for t in self.shards[0, :])
        return tuple(s)

    def gather(self) -> torch.Tensor:
        """The global tensor, on the mesh's first slot."""
        first = self.mesh.first
        dd, dm = self._joined("data"), self._joined("model")
        rows = []
        for row in self.shards:
            parts = gather_to(row if dm is not None else row[:1], first)
            rows.append(torch.cat(parts, dim=dm) if dm is not None
                        else parts[0])
        return torch.cat(rows, dim=dd) if dd is not None else rows[0]


def _as_tensor(A) -> torch.Tensor:
    """A tensor as it is; an array as a host tensor without a copy
    (float64 arrays are cast to float32 when placed, as JAX places them)."""
    return A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))


def shard(A, mesh: Mesh, spec=()) -> ShardedTensor:
    """Place A on the mesh by ``spec``: split along each named dimension
    with ``torch.tensor_split`` (uneven splits work), one copy of each piece
    per distinct device.  Arrays go from the host straight to each slot."""
    spec = _check_spec(spec)
    t = _as_tensor(A)
    dtype = (torch.float32 if t.dtype == torch.float64
             and not isinstance(A, torch.Tensor) else t.dtype)
    d, m = mesh.devices.shape
    rows = (torch.tensor_split(t, d, dim=spec.index("data"))
            if "data" in spec else [t] * d)
    shards = np.empty((d, m), dtype=object)
    copies: dict = {}
    for i, row in enumerate(rows):
        cols = (torch.tensor_split(row, m, dim=spec.index("model"))
                if "model" in spec else [row] * m)
        for j, piece in enumerate(cols):
            dev = mesh.devices[i, j]
            key = (i if "data" in spec else 0, j if "model" in spec else 0,
                   dev)
            if key not in copies:
                copies[key] = piece.to(dev, dtype)
            shards[i, j] = copies[key]
    return ShardedTensor(mesh, spec, shards)


def shard_patches(X, mesh: Mesh) -> ShardedTensor:
    """Split the patch (column) axis of X (p, N) over the 'data' axis."""
    return shard(X, mesh, (None, "data"))


def replicate(A, mesh: Mesh) -> ShardedTensor:
    """One copy of A on each distinct device of the mesh."""
    return shard(A, mesh, ())


def global_tensor(A, device) -> torch.Tensor:
    """A float32 tensor on ``device``: a ShardedTensor gathered, anything
    else converted."""
    if isinstance(A, ShardedTensor):
        A = A.gather()
    return greedy._as_f32(A, device)


def data_shards(X: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """The column splits of X (..., N) over the data rows, each on its
    row's first slot, in row order.  With fewer columns than rows the last
    rows get none and are left out."""
    devs = mesh.data_devices()
    n = max(1, min(len(devs), X.shape[-1]))
    return [x.to(dev) for dev, x in zip(devs, torch.tensor_split(X, n,
                                                                 dim=-1))]


def row_copies(D: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """D on each data row's first slot, one copy per distinct device."""
    return broadcast(D, mesh.data_devices())


def map_data(fn, Ds, X: torch.Tensor, mesh: Mesh) -> list:
    """``fn(d, x)`` once per data row: ``x`` the row's shard of X's columns
    (``data_shards``), ``d`` the row's copy of D (``row_copies``).  Every
    row is dispatched before any result is moved; the outputs (tensors, or
    tuples of them) come back on the first slot, in row order."""
    return gather_to([fn(d, x) for d, x in zip(Ds, data_shards(X, mesh))],
                     mesh.first)


def ksvd_train_step(X, D, T: int = 8, exact: bool = False,
                    svd_iters: int = 3):
    """One K-SVD training step: Batch-OMP coding and the sequential atom
    sweep.  Returns (D', Gamma') on the inputs' device."""
    # imported here: dict_learning.ksvd imports the encoder, which imports
    # this module
    from lyssandra_tpu_torch.dict_learning.ksvd import ksvd_atom_update

    device = resolve_device(None, X, D)
    X = greedy._as_f32(X, device)
    D = greedy._as_f32(D, device)
    Gamma = greedy.batch_omp(D, X, T, dense=True)
    return ksvd_atom_update(X, D, Gamma, exact=exact, svd_iters=svd_iters)


def sharded_ksvd_step(mesh: Mesh, T: int = 8, *, model_shard_atoms=False,
                      exact: bool = False, svd_iters: int = 3):
    """A ksvd_train_step over the mesh.  Returns a function
    (X, D) -> (D', Gamma'), both :class:`ShardedTensor`: D' replicated (or
    split over 'model' with ``model_shard_atoms``), Gamma' split over
    (None | 'model', 'data').

    X (p, N) and D (p, K) may be tensors, arrays or ShardedTensors.
    Coding runs per data slot (Batch-OMP with D replicated), or with
    ``model_shard_atoms`` through :func:`omp_model_sharded` (D split over
    'model'); the atom sweep runs on the gathered X and Gamma on the first
    slot (see the module docstring)."""
    from lyssandra_tpu_torch.dict_learning.ksvd import ksvd_atom_update
    from lyssandra_tpu_torch.parallel.model_sharded import omp_model_sharded

    first = mesh_device(mesh)
    d_spec = (None, "model") if model_shard_atoms else ()
    g_spec = ("model" if model_shard_atoms else None, "data")

    def step(X, D):
        X = global_tensor(X, first)
        D = global_tensor(D, first)
        if model_shard_atoms:
            Gamma = omp_model_sharded(D, X, T, mesh=mesh)
        else:
            Gamma = torch.cat(map_data(
                lambda d, x: greedy.batch_omp(d, x, T), row_copies(D, mesh),
                X, mesh), dim=1)
        D2, G2 = ksvd_atom_update(X, D, Gamma, exact=exact,
                                  svd_iters=svd_iters)
        return shard(D2, mesh, d_spec), shard(G2, mesh, g_spec)

    return step
