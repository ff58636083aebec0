"""Plain reference of configuration ksvd-c2: K-SVD with fixed-T OMP codes
(reference/omp.py, reference/ksvd.py's iteration split at its coding by
reference/ksvd_sweep.py) in float64; ``control=True`` runs it in float32
with TF32 products, the precision just below the configuration's.  The
training sets and the 'data' start are drawn here as the program draws
them, without it: numpy's patch draw (yardstick/color.py's frozen copy of
``patch_dataset``) and a CPU ``torch.Generator``."""

import numpy as np
import torch

from portbench.reference import ksvd_sweep
from portbench.reference.omp import dense, omp, tf32
from portbench.yardstick import color, generate


def _dt(control):
    return torch.float32 if control else torch.float64


def train_patches(cfg, s, device):
    """Training set s, (p, n_train) float32: n_train random patches of
    the configuration's images, each column's mean removed, drawn from
    numpy's default_rng(s)."""
    imgs = [img[:, :, None] for img in generate.clean_images(
        cfg["images"], cfg["image"])]
    X = color.patches(imgs, cfg["patch"], cfg["n_train"], s)
    return torch.from_numpy(X.astype(np.float32)).to(device)


def dictionary(X, cfg):
    """The 'data' start (p, K), float32: K distinct columns of X drawn by
    randperm from a CPU ``torch.Generator`` seeded by the configuration's
    seed, a column of norm below 1e-10 replaced by the N(0, 1) draw that
    follows it on the same generator, each scaled to unit norm."""
    gen = torch.Generator().manual_seed(cfg["seed"])
    p, N = X.shape
    cols = torch.randperm(N, generator=gen)[:cfg["K"]]
    noise = torch.randn((p, cfg["K"]), generator=gen).to(X.device)
    D = X[:, cols.to(X.device)]
    nrm = torch.linalg.vector_norm(D, dim=0)
    D = torch.where(nrm[None, :] < 1e-10, noise, D)
    return D / torch.linalg.vector_norm(D, dim=0, keepdim=True).clamp_min(
        1e-12)


def code(X, D, cfg, control=False):
    """(dense codes (K, N), err (N,) = ||x - D gamma||^2, nsel (N,)) of
    fixed-T OMP over D."""
    X, D = X.to(_dt(control)), D.to(_dt(control))
    with tf32(control):
        idx, gamma, err, nsel = omp(D, X, cfg["T"])
    return dense(idx, gamma, cfg["K"]), err, nsel


def from_codes(X, D, G, cfg, control=False):
    """(D out, stats (5,)) of the iteration whose coding over D gave the
    dense codes G: the B=1 sweep from them, then the replacement."""
    X, D, G = (t.to(_dt(control)) for t in (X, D, G))
    with tf32(control):
        return ksvd_sweep.from_codes(X, D, G, min_use=cfg["min_use"],
                                     max_coherence=cfg["max_coherence"])

