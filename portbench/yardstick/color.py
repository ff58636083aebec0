"""Config 4's colour patches: frozen copies of
``lyssandra_tpu_torch.utils.datasets.synthetic_color_image`` and of
``patch_dataset``'s draw (the same generator calls, gathered in bulk), so
that the benchmark's inputs do not move with the program."""

import numpy as np

from portbench.yardstick.images import synthetic_image


def synthetic_color_image(kind="texture", size=256, seed=0):
    """Deterministic synthetic RGB images in [0, 255], shape (H, W, 3):
    the channels share the grey image's luminance structure plus smooth
    chroma modulations."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    luma = synthetic_image(kind, size=size, seed=seed) / 255.0
    t = np.linspace(0, 1, size)
    xx, yy = np.meshgrid(t, t, indexing="ij")
    chans = []
    for c in range(3):
        chroma = np.zeros((size, size))
        for _ in range(3):
            cx, cy = rng.uniform(0, 1, 2)
            s = rng.uniform(0.25, 0.5)
            a = rng.uniform(-0.12, 0.12)
            chroma += a * np.exp(
                -(((xx - cx) ** 2 + (yy - cy) ** 2) / s**2)
            )
        gain = rng.uniform(0.85, 1.0)
        chans.append(np.clip(gain * luma + chroma, 0.0, 1.0))
    return 255.0 * np.stack(chans, axis=-1)


def patches(images, p, n, seed):
    """n random p x p patches of the (H, W, C) images, (C p^2, n) float64,
    channels stacked as leading row blocks, each column's mean removed:
    per image in turn n // len(images) + 1 corners, the rows drawn first
    and then the columns from numpy's default_rng(seed), the first n
    kept."""
    rng = np.random.default_rng(seed)
    per = n // len(images) + 1
    off = np.arange(p)
    cols = []
    for img in images:
        H, W = img.shape[:2]
        ii = rng.integers(0, H - p + 1, per)
        jj = rng.integers(0, W - p + 1, per)
        P = img[ii[:, None, None] + off[None, :, None],
                jj[:, None, None] + off[None, None, :]]     # (per, p, p, C)
        cols.append(np.moveaxis(P, -1, 1).reshape(per, -1))
    X = np.ascontiguousarray(np.concatenate(cols)[:n].T, dtype=np.float64)
    return X - X.mean(axis=0, keepdims=True)


def unit_patches(cfg):
    """Config 4's float32 unit-norm patches (p, n_train + n_holdout) of the
    configuration's images (size, seeds 0, 1, ... in the order named)."""
    imgs = [synthetic_color_image(k, cfg["image"], seed=s)
            for s, k in enumerate(cfg["images"])]
    X = patches(imgs, cfg["patch"], cfg["n_train"] + cfg["n_holdout"],
                cfg["data_seed"]).astype(np.float32)
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-8)
    return X
