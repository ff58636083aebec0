"""Feature extraction: encode -> spatial pooling (``lyssandra_tpu.apps.
features`` counterpart).

Dense patches per image, preprocessing, sparse codes over a (learned)
dictionary, spatial-pyramid max pooling of the absolute codes; a linear
classifier takes the pooled features (the ScSPM shape of Yang et al.
2009).  Every patch of a block of images goes through one encoder call.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.ops.patches import (
    contrast_normalize,
    extract_patches,
    n_patches,
    remove_dc,
)
from lyssandra_tpu_torch.solvers.encoder import SparseEncoder


def spatial_pyramid_pool(codes, grid: tuple[int, int],
                         levels=(1, 2, 4)) -> torch.Tensor:
    """Max-pool |codes| over a spatial pyramid.

    codes: (K, N) codes of patches laid out row-major on a grid (Hp, Wp);
    a leading batch axis (B, K, N) pools each image.  Returns features of
    length K * sum(l*l for l in levels) (B of them for a batch).  A grid
    that l does not divide is padded with zeros at its far edges."""
    codes = torch.as_tensor(codes)
    batched = codes.ndim == 3
    if not batched:
        codes = codes[None]
    B, K = codes.shape[:2]
    Hp, Wp = grid
    A = codes.abs().reshape(B, K, Hp, Wp)
    feats = []
    for l in levels:
        ph, pw = (-Hp) % l, (-Wp) % l
        Ap = F.pad(A, (0, pw, 0, ph))
        ch, cw = (Hp + ph) // l, (Wp + pw) // l
        cells = Ap.reshape(B, K, l, ch, l, cw)
        feats.append(cells.amax(dim=(3, 5)).reshape(B, K * l * l))
    out = torch.cat(feats, dim=1)
    return out if batched else out[0]


class FeatureExtractor:
    """Encode images into pooled sparse-code features.

    encoder: any SparseEncoder (default Batch-OMP T=10, whose coding is
    the fused OMP kernel on a GPU).  preprocess: 'dc' removes patch means;
    'dc+norm' also contrast-normalizes; 'dc+norm+whiten' then applies a
    fitted ``whitener`` (``ops.whitening.Whitener``).  D goes to ``device``
    (default: where D lies if it is a tensor, else the GPU); images go to
    D's device.
    """

    def __init__(
        self, D, *, patch: int = 8, stride: int = 4,
        encoder: SparseEncoder | None = None,
        levels=(1, 2, 4), preprocess: str = "dc", whitener=None,
        img_block: int = 64, device=None,
    ):
        device = resolve_device(device, D)
        if not isinstance(D, torch.Tensor):
            D = np.array(D, dtype=np.float32)     # a writable copy
        self.D = torch.as_tensor(D, dtype=torch.float32, device=device)
        self.patch = patch
        self.stride = stride
        self.encoder = encoder or SparseEncoder(
            "bomp", {"T": 10}, check_atoms=False)
        self.levels = levels
        self.preprocess = preprocess
        self.whitener = whitener
        self.img_block = img_block
        if preprocess.endswith("+whiten") and whitener is None:
            raise ValueError("preprocess includes 'whiten': pass whitener=")

    def _preprocess(self, X):
        X, _ = remove_dc(X)
        if "norm" in self.preprocess:
            X, _ = contrast_normalize(X)
        if self.preprocess.endswith("+whiten"):
            X = self.whitener.transform(X)
        return X

    def _images(self, imgs) -> torch.Tensor:
        if isinstance(imgs, (list, tuple)):
            imgs = torch.stack([torch.as_tensor(im) for im in imgs])
        return torch.as_tensor(imgs, dtype=torch.float32,
                               device=self.D.device)

    def transform_image(self, img) -> torch.Tensor:
        """One (H, W) or (H, W, C) image -> its pooled features.  A colour
        image codes its channel-stacked (C p^2, N) patches, pooled on the
        (H, W) patch grid, as the reference does."""
        img = self._images(img)
        if img.ndim == 2:
            return self.transform(img[None])[0]
        X = self._preprocess(extract_patches(img, self.patch, self.stride))
        codes = self.encoder.encode(X, self.D)
        grid = n_patches(img.shape[0], img.shape[1], self.patch, self.stride)
        return spatial_pyramid_pool(codes, grid, self.levels)

    def transform(self, imgs) -> torch.Tensor:
        """imgs: (B, H, W) array or a sequence of same-shape (H, W) arrays
        -> (B, F) features.  Blocks of ``img_block`` images, each one
        encoder call over all their patches; the last block is as large as
        what is left (the reference pads it with zero images, which code to
        zero, to reuse a compiled program: the features are the same)."""
        imgs = self._images(imgs)
        if imgs.ndim == 2:
            imgs = imgs[None]
        return torch.cat([
            self._transform_block(imgs[b:b + self.img_block])
            for b in range(0, imgs.shape[0], self.img_block)], dim=0)

    def _transform_block(self, imgs) -> torch.Tensor:
        B, H, W = imgs.shape
        p, s = self.patch, self.stride
        # (B, p^2, Np) -> (p^2, B*Np): image-major columns, each image's
        # patch grid row-major
        Xb = F.unfold(imgs[:, None], p, stride=s)
        Np = Xb.shape[-1]
        X = self._preprocess(Xb.transpose(0, 1).reshape(p * p, B * Np))
        codes = self.encoder.encode(X, self.D)          # (K, B*Np)
        K = codes.shape[0]
        per_img = codes.reshape(K, B, Np).transpose(0, 1)
        return spatial_pyramid_pool(per_img, n_patches(H, W, p, s),
                                    self.levels)
