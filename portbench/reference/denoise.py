"""Patch-based denoising (Elad & Aharon 2006, IEEE TIP 15(12)), plain:
every overlapping p x p patch, its mean removed, coded by error-mode OMP
with eps = gain * p * sigma and at most T_max atoms, rebuilt as
D gamma + mean, and blended with the noisy image:
x = (lam_w y + sum_ij R_ij^T x_ij) / (lam_w + sum_ij R_ij^T R_ij),
lam_w = lam / sigma.  Also the dictionaries and the patch sampler the
adaptive variant trains on."""

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.omp import dense, omp


def dct_dictionary(p, K):
    """The overcomplete separable 2-D DCT dictionary (p^2, K), K = k^2,
    unit columns, float64 numpy (each 1-D atom but the first has its mean
    removed)."""
    k = int(round(np.sqrt(K)))
    V = np.zeros((p, k))
    for i in range(k):
        v = np.cos(np.arange(p) * i * np.pi / k)
        if i > 0:
            v -= v.mean()
        V[:, i] = v / np.linalg.norm(v)
    D = np.kron(V, V)
    return D / np.linalg.norm(D, axis=0, keepdims=True)


def all_patches(img, p):
    """Every p x p patch of img (H, W) as the columns of (p^2, n), in
    raster order of the top-left corners, each patch row-major."""
    return F.unfold(img[None, None], p)[0]


def sampled_patches(img, p, n, seed):
    """n random p x p patches of img (H, W, float64 numpy), their means
    removed, as (p^2, n): the corners drawn as the adaptive denoiser's
    sampler draws them (numpy's default_rng(seed): n + 1 rows, then n + 1
    columns, the first n kept)."""
    H, W = img.shape
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, H - p + 1, n + 1)[:n]
    jj = rng.integers(0, W - p + 1, n + 1)[:n]
    off = np.arange(p)
    P = img[ii[:, None, None] + off[None, :, None],
            jj[:, None, None] + off[None, None, :]]
    X = np.ascontiguousarray(P.reshape(n, p * p).T, dtype=np.float64)
    return X - X.mean(axis=0, keepdims=True)


def denoise(D, noisy, *, p, sigma, gain, lam, T_max):
    """The restored image (H, W) in D's dtype and the patches' nsel."""
    y = noisy.to(D.dtype)
    H, W = y.shape
    X = all_patches(y, p)
    means = X.mean(dim=0)
    Xc = X - means[None, :]
    idx, gamma, _, nsel = omp(D, Xc, T_max, eps=gain * p * sigma)
    Xhat = D @ dense(idx, gamma, D.shape[1]) + means[None, :]
    acc = F.fold(Xhat[None], (H, W), p)[0, 0]
    cnt = F.fold(torch.ones_like(Xhat)[None], (H, W), p)[0, 0]
    lam_w = lam / sigma
    return (lam_w * y + acc) / (lam_w + cnt), nsel
