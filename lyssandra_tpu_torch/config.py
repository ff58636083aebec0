"""Frozen dataclass configs and the experiment-spec loader, copied from
``lyssandra_tpu.config``.

A copy and not an import: importing the reference package pulls in
``jax``.  ``tests/test_torch_package.py`` checks that the fields and
defaults have not drifted from the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class OMPConfig:
    """Greedy-solver config: T atoms at most; eps the residual-norm target
    (None: T-sparse mode); precision of the Gram and correlation products
    (every product here is full float32, whatever it says)."""

    T: int = 8
    eps: float | None = None
    precision: str = "highest"


@dataclass(frozen=True)
class LassoConfig:
    """Feature-sign-search config."""

    lam: float = 0.1
    max_active: int = 64         # active-set capacity
    max_iter: int = 100          # outer activation steps
    max_inner: int = 20          # refinement steps per activation


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
class OnlineDLConfig:
    K: int = 1024
    lam: float = 0.15
    batch_size: int = 4096       # lanes per coding call
    n_sweeps: int = 1
    beta: float = 1.0            # forgetting factor on sufficient statistics
    chunk_batches: int = 8       # minibatches per chunk (one metrics record)
    fs_max_active: int = 64      # feature-sign active-set capacity
    fs_max_iter: int = 60        # feature-sign outer iterations (in-loop)
    fs_max_inner: int = 6        # refinement budget
    fs_warm_start: int = 0       # OMP-seed atoms for the in-loop coder
    # unrolled growing-width cold start for the in-loop coder; None -> 0
    # (see OnlineDictionaryLearner._resolve_cold_unroll)
    fs_cold_unroll: int | None = None
    # the minibatch is coded as code_blocks sub-blocks one after another:
    # each feature-sign loop ends when its own slowest lane does.  The codes
    # are the same either way; the dictionary update sees the full minibatch
    code_blocks: int = 4
    seed: int = 0


@dataclass(frozen=True)
class LCKSVDConfig:
    K: int = 512
    T: int = 8
    n_iter: int = 10
    # weights for unit-norm inputs (their square roots enter the stack)
    alpha: float = 0.25          # label-consistency weight
    beta: float = 0.5            # classification weight
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


@dataclass(frozen=True)
class WhitenConfig:
    eps: float = 1e-2
    pca_dim: int | None = None   # None = ZCA, int = PCA-whitening to that dim


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh config: 'data' splits the patch axis, 'model' optionally
    the atom axis (``parallel.make_mesh``)."""

    data: int = -1               # -1 = all devices on the data axis
    model: int = 1


def from_yaml(path: str) -> dict[str, Any]:
    """Load an experiment spec dict from YAML, or from JSON where PyYAML is
    not installed."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        import json

        return json.loads(text)
    return yaml.safe_load(text)


def replace(cfg, **kw):
    """A copy of the frozen config ``cfg`` with the fields ``kw`` changed."""
    return dataclasses.replace(cfg, **kw)
