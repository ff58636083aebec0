"""Carrying the reference package's state into the port.

The "weights" of this system are a dictionary D and a config.  A
dictionary learned by ``lyssandra_tpu`` (for example by its K-SVD), saved
or handed over as a NumPy array, denoises and codes identically here.  The
learned state of the online learner, of the classifiers (``LCKSVD``,
``SRCClassifier``) and of a fitted ``Whitener`` comes across the same way,
as NumPy arrays.  A reference ``FeatureExtractor`` needs nothing of its
own: ``FeatureExtractor(dictionary_from_numpy(D), whitener=
whitener_from_reference(...), ...)`` with its settings extracts the same
features.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.apps.denoise import Denoiser
from lyssandra_tpu_torch.classify import LCKSVD, SRCClassifier
from lyssandra_tpu_torch.config import (
    DenoiseConfig,
    LCKSVDConfig,
    WhitenConfig,
)
from lyssandra_tpu_torch.dict_learning.online import OnlineDLState
from lyssandra_tpu_torch.ops.whitening import Whitener
from lyssandra_tpu_torch.solvers.encoder import SparseEncoder


def dictionary_from_numpy(D, device=None) -> torch.Tensor:
    """A (p, K) float array -> a contiguous float32 tensor on ``device``
    (default: the GPU; see ``_device.resolve_device``).  Warns when the
    atoms (columns) are not unit-norm, which every solver here assumes."""
    D = np.asarray(D)
    if D.ndim != 2:
        raise ValueError(f"dictionary must be (p, K), got shape {D.shape}")
    if not np.issubdtype(D.dtype, np.floating):
        raise TypeError(f"dictionary must be floating point, got {D.dtype}")
    if not np.isfinite(D).all():
        raise ValueError("dictionary has non-finite entries")
    norms = np.linalg.norm(D.astype(np.float64), axis=0)
    if not np.allclose(norms, 1.0, atol=1e-4):
        warnings.warn(
            f"dictionary atoms are not unit-norm (norms in "
            f"[{norms.min():.4g}, {norms.max():.4g}])", stacklevel=2)
    # a contiguous, writable float32 copy the tensor owns
    return torch.from_numpy(np.array(D, dtype=np.float32, order="C")).to(
        resolve_device(device))


def denoiser_from_reference(D_np, cfg_dict: dict, device=None) -> Denoiser:
    """A Denoiser from a reference dictionary and the fields of a
    reference ``DenoiseConfig`` (``dataclasses.asdict`` of it), on
    ``device`` (default: the GPU)."""
    return Denoiser(dictionary_from_numpy(D_np, device),
                    DenoiseConfig(**cfg_dict), device=device)


def encoder_from_reference(algorithm: str, params: dict | None = None, *,
                           block: int | None = None,
                           check_atoms: bool = True,
                           device=None) -> SparseEncoder:
    """A SparseEncoder from a reference encoder's settings: its algorithm
    name, its params (array values such as ``groups`` become NumPy arrays,
    NumPy scalars become Python numbers) and its block size.  The encoder
    resolves ``device`` at each ``encode`` (``_device.resolve_device``)."""
    def plain(v):
        if isinstance(v, np.generic):
            return v.item()
        if hasattr(v, "__array__") and np.ndim(v) > 0:
            return np.asarray(v)
        return v

    return SparseEncoder(
        algorithm, {k: plain(v) for k, v in (params or {}).items()},
        block=block, check_atoms=check_atoms, device=device)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(
        device)


def online_state_from_reference(D, A, B, step=0,
                                device=None) -> OnlineDLState:
    """An online-learning state from the reference's ``OnlineDLState``
    fields (D (p, K), A (K, K), B (p, K), step) as NumPy arrays, on
    ``device`` (default: the GPU); set it as a learner's ``state``.  The
    atoms of D have norm at most 1, not 1, so they are not checked."""
    device = resolve_device(device)
    return OnlineDLState(_tensor(D, device),
                         _tensor(A, device), _tensor(B, device),
                         torch.tensor(int(np.asarray(step)),
                                      dtype=torch.int32))


def lcksvd_from_reference(D, A, W, C: int, cfg_dict: dict | None = None, *,
                          predict_T: int | None = None,
                          device=None) -> LCKSVD:
    """A fitted LCKSVD from a reference one's ``D_``, ``A_``, ``W_`` and
    ``C_`` (and the fields of its ``LCKSVDConfig``, ``dataclasses.asdict``
    of it), on ``device`` (default: the GPU); it predicts as fitted."""
    clf = LCKSVD(LCKSVDConfig(**(cfg_dict or {})), predict_T=predict_T,
                 device=device)
    device = resolve_device(device)
    clf.D_ = dictionary_from_numpy(D, device)
    clf.A_ = _tensor(A, device)
    clf.W_ = _tensor(W, device)
    clf.C_ = int(C)
    return clf


def src_from_reference(D, y, T: int = 10, *, normalize: bool = True,
                       device=None) -> SRCClassifier:
    """A fitted SRCClassifier from a reference one's ``D_`` (the already
    normalized training samples) and ``y_``, on ``device`` (default: the
    GPU)."""
    clf = SRCClassifier(T, normalize=normalize, device=device)
    return clf._set_dictionary(_tensor(D, resolve_device(device)), y)


def whitener_from_reference(mean, W, Winv, cfg_dict: dict | None = None,
                            device=None) -> Whitener:
    """A fitted Whitener from a reference one's ``mean_`` (p, 1), ``W_``
    and ``Winv_`` (and the fields of its ``WhitenConfig``,
    ``dataclasses.asdict`` of it), on ``device`` (default: the GPU); it
    transforms as fitted."""
    device = resolve_device(device)
    wh = Whitener(WhitenConfig(**(cfg_dict or {})), device=device)
    wh.mean_ = _tensor(np.reshape(mean, (-1, 1)), device)
    wh.W_ = _tensor(W, device)
    wh.Winv_ = _tensor(Winv, device)
    return wh
