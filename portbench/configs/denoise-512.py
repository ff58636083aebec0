"""Plain reference of configuration denoise-512: the Elad-Aharon denoiser
(reference/denoise.py) and one K-SVD iteration (reference/ksvd.py) in
float64; ``control=True`` runs them in float32 with TF32 products, the
precision just below the configuration's."""

import torch

from portbench.reference import denoise as den
from portbench.reference.ksvd import ksvd_iteration as _ksvd
from portbench.reference.omp import tf32


def _dt(control):
    return torch.float32 if control else torch.float64


def dictionary(cfg, device, control=False):
    """The DCT dictionary (patch^2, K)."""
    return torch.as_tensor(den.dct_dictionary(cfg["patch"], cfg["K"]),
                           dtype=_dt(control), device=device)


def denoise(D, noisy, cfg, control=False):
    """(restored image, the patches' nsel)."""
    with tf32(control):
        return den.denoise(D.to(_dt(control)), noisy, p=cfg["patch"],
                           sigma=cfg["sigma"], gain=cfg["gain"],
                           lam=cfg["lam"], T_max=cfg["T_max"])


def train_patches(noisy, cfg, device, control=False):
    """The n_train patches the adaptive denoiser trains on, (patch^2, n)."""
    img = noisy.detach().to("cpu", torch.float64).numpy()
    X = den.sampled_patches(img, cfg["patch"], cfg["n_train"],
                            cfg["train_seed"])
    return torch.as_tensor(X, dtype=_dt(control), device=device)


def ksvd_iteration(X, D, cfg, control=False):
    """(D after one K-SVD iteration from D, the coding's nsel)."""
    with tf32(control):
        return _ksvd(X.to(_dt(control)), D.to(_dt(control)),
                     T=cfg["T_max"], eps=cfg["gain"] * cfg["patch"]
                     * cfg["sigma"], min_use=cfg["min_use"],
                     max_coherence=cfg["max_coherence"])
