"""The work of config 4's calls, counted from their inputs and the
reference's lasso optima, whatever implements them: operations in the
cheapest form at these shapes, each input byte read once and each output
byte written once.  Floats are 4 bytes (the port is float32)."""

import numpy as np

F32 = 4


def fs_cold_kernel(K, tun, nnz, n_atoms):
    """One fused feature-sign cold start (K6) over len(nnz) lanes in its
    Gram form: it reads A0 = X^T D (N, K) and the Gram columns of the
    n_atoms distinct atoms the lanes activate, and writes the gradient
    (N, K), tun slots a lane (13 bytes each: atom, mask, sign, value) and
    a done flag.  A lane whose optimum has s atoms runs min(s, tun)
    activation steps, one atom each; the lane's first test is K
    comparisons, and the step that leaves a atoms active costs the
    violator search (K), the gradient over the active atoms (2Ka) with its
    KKT test (2K), and the solve of the (a, a) system from the factor of
    the step before (3a^2: its new row and two triangular solves).
    Returns (flops, bytes)."""
    s = np.minimum(np.asarray(nnz, dtype=np.float64).ravel(), tun)
    N = s.size
    flops = (K * N + float(np.sum(3 * K * s + K * s * (s + 1)
                                  + s * (s + 1) * (2 * s + 1) / 2)))
    nbytes = F32 * (2 * N * K + K * n_atoms) + 13 * N * tun + N
    return flops, nbytes


def minibatch(p, K, nnz):
    """One Mairal update of len(nnz) lanes whose codes have nnz[i]
    nonzeros: A0 = X^T D (2pK a lane), Gamma Gamma^T and X Gamma^T over
    the nonzeros (2 s^2 and 2ps a lane), the sweep's K products D a_k
    (2pK^2), and the objective's D Gamma (2ps a lane).  Returns flops."""
    s = np.asarray(nnz, dtype=np.float64).ravel()
    return float(2 * p * K * s.size + np.sum(2 * s * s + 4 * p * s)
                 + 2 * p * K * K)


def holdout(p, K, n, iters):
    """The holdout metric: D^T X once, 16 power steps and a Rayleigh
    quotient (4pK each), then ``iters`` FISTA iterations in the residual
    form (D y, then D^T of it: 4pK a lane each).  Returns flops."""
    return float(2 * p * K * n + 17 * 4 * p * K + iters * 4 * p * K * n)


def task(p, K, nnzs, n_holdout=0, holdout_iters=0):
    """A task of minibatches whose codes have the nonzeros ``nnzs`` (a
    list of arrays), with the holdout metric on n_holdout signals where
    given: each minibatch's signals read and D, A, B read and written
    once.  Returns (flops, bytes)."""
    flops = sum(minibatch(p, K, s) for s in nnzs)
    n = sum(np.asarray(s).size for s in nnzs)
    nbytes = F32 * (p * (n + n_holdout) + 4 * p * K + 2 * K * K)
    if n_holdout:
        flops += holdout(p, K, n_holdout, holdout_iters)
    return flops, nbytes
