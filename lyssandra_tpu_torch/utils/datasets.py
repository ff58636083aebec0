"""Synthetic standard images, the image loaders and the patch sampler,
copied from ``lyssandra_tpu.utils.datasets`` (a copy and not an import:
importing the reference package pulls in ``jax``).
``tests/test_torch_package.py`` and ``tests/test_torch_lasso.py`` check
that the copies give the reference's pixels and patches."""

from __future__ import annotations

import os
import zlib

import numpy as np


def load_image(path: str, gray: bool = True) -> np.ndarray:
    """Load an image file to float64 [0, 255] (.npy/.npz directly, other
    formats through PIL, which must be installed)."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if hasattr(arr, "keys"):
            arr = arr[list(arr.keys())[0]]
        return np.asarray(arr, np.float64)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "PIL unavailable; provide .npy images instead") from e
    img = Image.open(path)
    if gray:
        img = img.convert("L")
    return np.asarray(img, np.float64)


def load_image_folders(
    root: str, *, gray: bool = True, size: int | None = None,
    extensions: tuple[str, ...] = (".png", ".jpg", ".jpeg", ".bmp",
                                   ".tif", ".tiff", ".npy"),
    allow_mixed: bool = False,
) -> tuple[list[np.ndarray], np.ndarray, list[str]]:
    """Class-per-subdirectory image dataset: returns (images, labels,
    class_names), classes in sorted order, files sorted within each.
    ``size``: an optional square resize (PIL bilinear; .npy images, which
    need no PIL, must already have it).  Images of different shapes raise
    unless ``allow_mixed``."""
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise ValueError(f"no class subdirectories under {root!r}")
    images: list[np.ndarray] = []
    labels: list[int] = []
    for c, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith(extensions):
                continue
            path = os.path.join(cdir, fname)
            if size is not None and not fname.lower().endswith(".npy"):
                from PIL import Image

                img = Image.open(path)
                if gray:
                    img = img.convert("L")
                img = img.resize((size, size), Image.BILINEAR)
                arr = np.asarray(img, np.float64)
            else:
                arr = load_image(path, gray=gray)
            images.append(arr)
            labels.append(c)
    if not images:
        raise ValueError(f"no images with {extensions} under {root!r}")
    shapes = {im.shape for im in images}
    if len(shapes) > 1 and not allow_mixed:
        raise ValueError(
            f"folder images have mismatched shapes {sorted(shapes)}; "
            "pass size= to resize them (or allow_mixed=True)")
    return images, np.asarray(labels, np.int32), classes


def synthetic_image(
    kind: str = "texture", size: int = 256, seed: int = 0
) -> np.ndarray:
    """Deterministic synthetic grayscale images in [0, 255] (float64).

    kinds: 'smooth' (low-frequency blobs), 'texture' (oriented stripes over
    smooth background — barbara-like), 'edges' (piecewise-constant blocks —
    cartoon-like), 'mix' (quadrants of the above).
    """
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, size)
    xx, yy = np.meshgrid(t, t, indexing="ij")

    def smooth():
        img = np.zeros((size, size))
        for _ in range(6):
            cx, cy = rng.uniform(0, 1, 2)
            s = rng.uniform(0.08, 0.3)
            a = rng.uniform(-1, 1)
            img += a * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / s**2))
        return img

    def texture():
        img = 0.6 * smooth()
        for _ in range(4):
            f = rng.uniform(15, 45)
            th = rng.uniform(0, np.pi)
            cx, cy = rng.uniform(0.2, 0.8, 2)
            s = rng.uniform(0.1, 0.25)
            mask = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / s**2))
            img += 0.5 * mask * np.sin(
                2 * np.pi * f * (xx * np.cos(th) + yy * np.sin(th))
            )
        return img

    def edges():
        img = np.zeros((size, size))
        for _ in range(8):
            x0, y0 = rng.uniform(0, 0.8, 2)
            w, h = rng.uniform(0.1, 0.4, 2)
            img[(xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + h)] += \
                rng.uniform(-1, 1)
        return img

    if kind == "smooth":
        img = smooth()
    elif kind == "texture":
        img = texture()
    elif kind == "edges":
        img = edges()
    elif kind == "mix":
        h = size // 2
        img = np.zeros((size, size))
        img[:h, :h] = smooth()[:h, :h]
        img[:h, h:] = texture()[:h, h:]
        img[h:, :h] = edges()[h:, :h]
        img[h:, h:] = (texture() + edges())[h:, h:]
    else:
        raise ValueError(kind)
    img -= img.min()
    img /= max(img.max(), 1e-12)
    return 255.0 * img


def synthetic_color_image(
    kind: str = "texture", size: int = 256, seed: int = 0,
) -> np.ndarray:
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


def standard_test_image(
    name: str = "barbara", size: int = 256, color: bool = False
) -> np.ndarray:
    """Stand-ins for the standard denoising test images.

    If a real image file exists under $LYSSA_DATA_DIR/<name>.{png,pgm,npy},
    it is loaded; otherwise a procedural image of the matching kind is
    generated ('barbara' -> oriented textures, 'lena' -> smooth + edges,
    'boat' -> edges), seeded by a stable digest of the name.
    """
    data_dir = os.environ.get("LYSSA_DATA_DIR", "")
    for ext in (".png", ".pgm", ".npy"):
        path = os.path.join(data_dir, name + ext)
        if data_dir and os.path.exists(path):
            return load_image(path, gray=not color)
    kind = {"barbara": "texture", "lena": "mix", "boat": "edges"}.get(
        name, "mix")
    # Python's str hash is salted per process; crc32 is not
    seed = zlib.crc32(name.encode())
    if color:
        return synthetic_color_image(kind, size=size, seed=seed)
    return synthetic_image(kind, size=size, seed=seed)


def patch_dataset(
    images, p: int = 8, n_patches: int = 50000, seed: int = 0,
    remove_dc: bool = True,
) -> np.ndarray:
    """Sample random p x p patches from a list of images -> (p*p, N).

    Color images (H, W, C) yield (C*p*p, N) columns with channels stacked
    as leading row blocks (the layout of ``ops.patches.extract_patches``).
    """
    rng = np.random.default_rng(seed)
    per = n_patches // len(images) + 1
    cols = []
    for img in images:
        H, W = img.shape[:2]
        ii = rng.integers(0, H - p + 1, per)
        jj = rng.integers(0, W - p + 1, per)
        for i, j in zip(ii, jj):
            patch = img[i : i + p, j : j + p]
            if patch.ndim == 3:
                patch = np.moveaxis(patch, -1, 0)   # channel-major blocks
            cols.append(patch.reshape(-1))
    X = np.stack(cols[:n_patches], axis=1).astype(np.float64)
    if remove_dc:
        X -= X.mean(axis=0, keepdims=True)
    return X
