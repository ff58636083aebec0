"""Dictionary construction and atom bookkeeping
(``lyssandra_tpu.ops.dictionaries`` counterpart).

The DCT dictionaries are set-up code in NumPy (float64, as the reference
builds them), handed to torch as ``dtype`` (float32 by default, the port's
working type) on the requested device.  The bookkeeping that K-SVD runs in its loop
(``normalize_atoms``, ``replace_unused_atoms``) stays on the device and
never reads a value on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device


def dct_dictionary(p: int, K: int, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """Overcomplete 2-D DCT dictionary (p^2, K), unit columns. K = k^2.
    As ``dtype``, on ``device`` (default: the GPU; see
    ``_device.resolve_device``)."""
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
    return torch.as_tensor(D, dtype=dtype, device=resolve_device(device))


def dct_dictionary_color(p: int, K: int, channels: int = 3,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> torch.Tensor:
    """Channel-replicated DCT baseline for colour patches: (C p^2, K), as
    ``dtype`` on ``device`` as ``dct_dictionary``."""
    D = dct_dictionary(p, K, dtype, device)
    return D.repeat(channels, 1) / np.sqrt(channels)


def init_dictionary(X, K: int, method: str = "data", seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """Unit-norm initial dictionary (p, K) for signals X (p, N): 'random'
    Gaussian, 'data' columns of X, or 'dct'.

    'dct' is the 2-D DCT dictionary for p = q^2, and the channel-replicated
    colour DCT for p = C q^2 (C in 3, 4, 2); both equal the reference's
    bit for bit in float32.

    'random' and 'data' draw from a ``torch.Generator`` seeded by ``seed``
    on the CPU and then move to the device, so a fit on the CPU and one on
    the GPU start from the same D.  'data' takes K distinct columns of X
    (with replacement only when N < K) and replaces columns of norm below
    1e-10 by Gaussian noise.  These draws cannot equal ``jax.random``'s, so
    the port's D differs from the reference's for the same seed; hand a D0
    across to compare the two.

    Returns ``dtype`` (float32 by default; the draws are float32 in every
    type).  Runs on ``device`` (default: where X lies if it is a tensor,
    else the GPU; see ``_device.resolve_device``).
    """
    device = resolve_device(device, X)
    if method == "dct":
        p2 = X.shape[0]
        q = int(round(np.sqrt(p2)))
        if q * q == p2:
            return dct_dictionary(q, K, dtype, device)
        for C in (3, 4, 2):
            q = int(round(np.sqrt(p2 / C)))
            if C * q * q == p2:
                return dct_dictionary_color(q, K, C, dtype, device)
        raise ValueError(f"signal dim {p2} is not p^2 or C*p^2")
    gen = torch.Generator().manual_seed(seed)
    p, N = X.shape
    if method == "random":
        D = torch.randn((p, K), generator=gen).to(device)
    elif method == "data":
        if N < K:
            cols = torch.randint(0, N, (K,), generator=gen)
        else:
            cols = torch.randperm(N, generator=gen)[:K]
        noise = torch.randn((p, K), generator=gen).to(device)
        X = torch.as_tensor(X, dtype=torch.float32, device=device)
        D = X[:, cols.to(device)]
        nrm = torch.linalg.vector_norm(D, dim=0)
        D = torch.where(nrm[None, :] < 1e-10, noise, D)
    else:
        raise ValueError(method)
    return normalize_atoms(D.to(dtype))


def normalize_atoms(D: torch.Tensor) -> torch.Tensor:
    """Scale every column to unit l2 norm."""
    return D / torch.linalg.vector_norm(D, dim=0, keepdim=True).clamp_min(
        1e-12)


def mutual_coherence(D: torch.Tensor) -> torch.Tensor:
    """max_{i != j} |d_i . d_j| for a unit-norm dictionary (a 0-d tensor)."""
    G = (D.T @ D).abs()
    return (G - torch.diag(torch.diag(G))).max()


def worst_first(err: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of err, largest first and the lower
    index first among equal values (``lax.top_k``'s order; a stable sort,
    since ``torch.topk`` promises no order among ties)."""
    return torch.sort(err, descending=True, stable=True).indices[:k]


def replacement_atoms(X, D, err, use, min_use, max_coherence):
    """The atom-replacement rule shared by the dense and compact K-SVD
    steps.  Atom k is bad if it has fewer than ``min_use`` users or is
    more than ``max_coherence``-coherent with a LATER atom (upper triangle
    only: the oracle's sequential loop replaces the lower-indexed member of
    a coherent pair and keeps the other).  Bad atom ranked r (in index
    order) takes the r-th worst-reconstructed signal of ``err``,
    normalized.  Returns (D with the bad atoms replaced, bad (K,) bool)."""
    K = D.shape[1]
    order = worst_first(err, min(K, err.shape[0]))
    G = torch.triu((D.T @ D).abs(), diagonal=1)
    bad = (use < min_use) | (G.max(dim=1).values > max_coherence)
    rank = torch.cumsum(bad, dim=0) - 1
    repl = X[:, order[rank % order.shape[0]]]
    repl = repl / torch.linalg.vector_norm(
        repl, dim=0, keepdim=True).clamp_min(1e-10)
    return torch.where(bad[None, :], repl, D), bad


def replace_unused_atoms(X, D, Gamma, min_use: int = 1,
                         max_coherence: float = 0.99, *,
                         return_mask: bool = False):
    """Replace dead (< min_use users) or overly coherent atoms with the
    worst-reconstructed signals, renormalized
    (``lyssandra_tpu.ops.dictionaries.replace_unused_atoms``; see
    ``replacement_atoms`` for the rule).  X (p, N), D (p, K), Gamma (K, N)
    tensors on one device.  Returns D, or (D, bad) with ``return_mask``."""
    R = X - D @ Gamma
    use = (Gamma.abs() > 0).sum(dim=1)
    D_out, bad = replacement_atoms(X, D, (R * R).sum(dim=0), use, min_use,
                                   max_coherence)
    return (D_out, bad) if return_mask else D_out
