"""Plain reference of configuration bomp-k1024: OMP (reference/omp.py) in
float64; ``control=True`` runs it in the precision just below the
configuration's, float32 with TF32 products."""

import torch

from portbench.reference.omp import omp, tf32


def code(D, X, cfg, control=False):
    """(idx, gamma, err, nsel) of X (p, n) over D (p, K) at cfg's T."""
    dt = torch.float32 if control else torch.float64
    with tf32(control):
        return omp(D.to(dt), X.to(dt), cfg["T"])
