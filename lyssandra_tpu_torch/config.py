"""Frozen dataclass configs, copied from ``lyssandra_tpu.config``.

A copy and not an import: importing the reference package pulls in
``jax``.  ``tests/test_torch_package.py`` checks that the fields and
defaults have not drifted from the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass


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
