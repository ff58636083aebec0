"""Frozen dataclass configs, copied from ``lyssandra_tpu.config``.

A copy and not an import: importing the reference package pulls in
``jax``.  ``tests/test_torch_package.py`` checks that the fields and
defaults have not drifted from the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KSVDConfig:
    K: int = 512
    T: int = 8
    n_iter: int = 20
    init: str = "data"           # random | data | dct
    exact_svd: bool = False      # exact rank-1 SVD vs approx power step
    svd_iters: int = 3           # power iterations when exact_svd=True
    replace_dead: bool = True
    min_use: int = 1
    max_coherence: float = 0.99
    # atoms updated per sweep step: 1 = exact sequential Gauss-Seidel
    # (oracle semantics); B>1 batches B atoms into block products (Jacobi
    # within the block), see ksvd.ksvd_atom_update
    atom_block: int = 1
    # code-matrix representation during fit: 'dense' (K, N) Gamma,
    # 'compact' idx/gamma (N, T) (no (K, N) array anywhere), or 'auto'
    # (compact when the dense Gamma would exceed 1 GiB).  Compact implies
    # block atom updates (>= 8)
    codes: str = "auto"
    seed: int = 0


@dataclass(frozen=True)
class DenoiseConfig:
    patch: int = 8
    sigma: float = 25.0
    gain: float = 1.15
    lam: float = 0.5
    T_max: int = 32
    block: int = 16384           # patches per coding call off the fast path
    # lane ordering fed to the error-stopped kernel: "raster" (extraction
    # order) or "energy" (sorted by post-DC patch energy); the codes are
    # identical either way
    order: str = "raster"
