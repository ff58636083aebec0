"""The procedural stand-ins for the standard denoising test images, frozen
copies of ``lyssandra_tpu_torch.utils.datasets.synthetic_image`` and
``standard_test_image`` (without the look-up of image files: the benchmark
reads nothing outside its checkout)."""

import zlib

import numpy as np


def synthetic_image(kind="texture", size=256, seed=0):
    """Deterministic synthetic grayscale images in [0, 255] (float64).

    kinds: 'smooth' (low-frequency blobs), 'texture' (oriented stripes over
    smooth background, barbara-like), 'edges' (piecewise-constant blocks,
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


def standard_test_image(name="barbara", size=256):
    """The procedural stand-in of a standard test image: 'barbara' ->
    oriented textures, 'lena' -> smooth + edges, 'boat' -> edges, seeded
    by a stable digest of the name."""
    kind = {"barbara": "texture", "lena": "mix", "boat": "edges"}.get(
        name, "mix")
    return synthetic_image(kind, size=size, seed=zlib.crc32(name.encode()))
