"""Dictionary construction (``lyssandra_tpu.ops.dictionaries`` counterpart).

Construction is set-up code in NumPy (float64, as the reference builds it),
handed to torch as float32 (the port's one dtype) on the requested
device.
"""

from __future__ import annotations

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device


def dct_dictionary(p: int, K: int, device=None) -> torch.Tensor:
    """Overcomplete 2-D DCT dictionary (p^2, K), unit columns. K = k^2.
    On ``device`` (default: the GPU; see ``_device.resolve_device``)."""
    k = int(round(np.sqrt(K)))
    if k * k != K:
        raise ValueError("K must be a perfect square")
    V = np.zeros((p, k))
    for i in range(k):
        v = np.cos(np.arange(p) * i * np.pi / k)
        if i > 0:
            v -= v.mean()
        V[:, i] = v / np.linalg.norm(v)
    D = np.kron(V, V)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    return torch.as_tensor(D, dtype=torch.float32,
                           device=resolve_device(device))


def dct_dictionary_color(p: int, K: int, channels: int = 3,
                         device=None) -> torch.Tensor:
    """Channel-replicated DCT baseline for colour patches: (C p^2, K), on
    ``device`` as ``dct_dictionary``."""
    D = dct_dictionary(p, K, device)
    return D.repeat(channels, 1) / np.sqrt(channels)


def normalize_atoms(D: torch.Tensor) -> torch.Tensor:
    """Scale every column to unit l2 norm."""
    return D / torch.linalg.vector_norm(D, dim=0, keepdim=True).clamp_min(
        1e-12)
