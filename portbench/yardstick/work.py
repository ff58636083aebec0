"""The work a call needs, counted from its inputs and the reference's
answers, whatever implements it: operations in the Gram form of Batch-OMP
(Rubinstein, Zibulevsky & Elad 2008), each input byte read once and each
output byte written once.  Floats are 4 bytes (the port is float32)."""

import numpy as np

F32 = 4


def gram_omp_flops(p, K, nsel, n_atoms, gs=1):
    """Operations of (group) OMP in its cheapest form at these shapes, the
    Gram form of Batch-OMP (alpha = alpha0 - G_I gamma_I), over lanes that
    selected nsel[n] atoms (gs = 1) or groups of gs atoms: the Gram
    columns of the n_atoms distinct atoms any lane selected (2pK each);
    ||x||^2 per lane (2p), and alpha0 = D^T x (2pK) per lane that runs a
    step; at step s, with n = gs (s - 1) atoms in the support, the
    correlation update (2Kn), the scores and their argmax (K for single
    atoms; 2K + K/gs for the group norms), the factor's new block
    (gs n^2 for its triangular solves, 2 gs^2 n for the Schur complement,
    gs^3 / 3 for its Cholesky), the two solves for gamma (2 (n + gs)^2)
    and the error from the normal equations (2 (n + gs)).  (Frozen copy
    of ``chip_smoke.gram_omp_flops``; nsel is an integer array.)"""
    counts = np.bincount(np.asarray(nsel, dtype=np.int64).ravel()).tolist()
    score = K if gs == 1 else 2 * K + K // gs
    total = 2 * p * K * n_atoms + 2 * p * sum(counts)
    for m, c in enumerate(counts):
        if m == 0:
            continue
        lane = 2 * p * K
        for s in range(1, m + 1):
            n = gs * (s - 1)
            lane += (2 * K * n + score + gs * n * n + 2 * gs * gs * n
                     + gs ** 3 / 3 + 2 * (n + gs) ** 2 + 2 * (n + gs))
        total += c * lane
    return total


def scale_nsel(nsel, n_lanes):
    """A sample's nsel stood in for n_lanes lanes: each sampled lane
    counts n_lanes / len(nsel) times (rounded per value of nsel)."""
    nsel = np.asarray(nsel, dtype=np.int64).ravel()
    counts = np.bincount(nsel).astype(np.float64) * (n_lanes / nsel.size)
    return np.repeat(np.arange(counts.size), np.rint(counts).astype(np.int64))


def encode_call(p, K, T, nsel, n_atoms):
    """One compact encode of len(nsel) signals (idx, gamma, err, nsel
    out): Gram-form work with G counted once; X and D read, the codes
    written.  Returns (flops, bytes)."""
    N = len(nsel)
    flops = gram_omp_flops(p, K, nsel, n_atoms)
    nbytes = F32 * (p * N + p * K) + N * (2 * T * F32 + 2 * F32)
    return flops, nbytes


def omp_kernel(p, K, T, nsel):
    """One fused OMP launch (K1, or K2 at T = its cap) over len(nsel)
    lanes that reads X, D, its transpose and the precomputed G, and
    writes the codes: the lanes' work without the G columns, which the
    product kernel computes.  Returns (flops, bytes)."""
    N = len(nsel)
    flops = gram_omp_flops(p, K, nsel, 0)
    nbytes = F32 * (p * N + 2 * p * K + K * K) + N * (2 * T * F32 + 2 * F32)
    return flops, nbytes


def denoise_call(p, K, H, W, nsel, n_atoms):
    """One restored image from its noisy image and D: Gram-form eps-OMP
    of every patch at the reference's nsel, G once, and D Gamma over the
    selected atoms (2p a coefficient); the image and D read, the image
    written.  Returns (flops, bytes)."""
    nsel = np.asarray(nsel)
    flops = gram_omp_flops(p, K, nsel, n_atoms) + 2 * p * int(nsel.sum())
    nbytes = F32 * (2 * H * W + p * K)
    return flops, nbytes


def ksvd_iteration(p, K, nsel, n_atoms):
    """One K-SVD iteration over len(nsel) signals with a B=1 sweep:
    Gram-form coding at the reference's nsel, the residual X - D Gamma
    over the selected atoms (2p a coefficient), and per atom over its
    users the rank-1 update d = E g, g = E^T d and the residual's two
    rank-1 corrections (8p a coefficient in all).  Returns flops."""
    nnz = int(np.asarray(nsel).sum())
    return gram_omp_flops(p, K, nsel, n_atoms) + 2 * p * nnz + 8 * p * nnz
