"""The one traffic generator: every input of a run is drawn here from the
run's seed, on the device, with one ``torch.Generator`` per run and in a
few large calls.  What is drawn and how much comes from the traffic mix's
parameters; the draws are those of the north-star benchmark (``bench.py``:
N(0, 1) signals over a Gaussian dictionary with unit-norm atoms) and of
the denoising experiments (a fixed clean image plus N(0, sigma^2) noise)."""

import numpy as np
import torch

from portbench.yardstick.images import standard_test_image


def generator(seed, device):
    """The run's generator on ``device``; any whole number up to 2**63 - 1
    seeds it."""
    return torch.Generator(device=device).manual_seed(int(seed))


def unit_gaussian_dictionary(p, K, gen, device):
    """D (p, K): N(0, 1) entries, each column scaled to unit norm."""
    D = torch.randn((p, K), generator=gen, device=device, dtype=torch.float32)
    return D / torch.linalg.vector_norm(D, dim=0, keepdim=True)


def gaussian_signals(p, N, gen, device):
    """X (p, N) with N(0, 1) entries."""
    return torch.randn((p, N), generator=gen, device=device,
                       dtype=torch.float32)


def clean_images(names, size):
    """The clean stand-ins (float64 numpy, [0, 255]), one per name."""
    return [standard_test_image(n, size) for n in names]


def noisy_pool(clean, sigma, count, gen, device):
    """``count`` noisy float32 images: clean[i % len(clean)] plus
    N(0, sigma^2) noise, all noise drawn in one call.  Every seed gets the
    same clean images, so the work per image does not move with it.
    Returns a list of (H, W) tensors."""
    H, W = clean[0].shape
    base = torch.as_tensor(np.stack(clean), dtype=torch.float32,
                           device=device)
    noise = torch.randn((count, H, W), generator=gen, device=device,
                        dtype=torch.float32)
    return [base[i % len(clean)] + sigma * noise[i] for i in range(count)]


def shuffle(a, seed):
    """Put the array ``a`` in an order drawn from the seed, in place."""
    np.random.default_rng([int(seed) & (2**63 - 1), 6]).shuffle(a)


def sample_indices(seed, salt, n, count):
    """``count`` distinct indices in [0, n) drawn from the seed (numpy's
    generator; a different ``salt`` draws another set), sorted."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), salt])
    return np.sort(rng.choice(n, size=min(count, n), replace=False))
