"""The work of a lasso encode (``SparseEncoder("lasso")``: feature-sign
search a block of lanes), counted from its inputs and the reference's
lasso optima, whatever implements it: operations in the cheapest form at
these shapes, each input byte read once and each output byte written
once.  Floats are 4 bytes (the port is float32).  The polish re-solves
lanes already coded, so it is no counted work."""

import numpy as np

from portbench.yardstick import lasso_work

F32 = 4


def call(p, K, nnz):
    """One encode of len(nnz) lanes whose optima have nnz[i] nonzeros into
    dense codes (K, N): A0 = X^T D (2pK a lane), then per lane the
    feature-sign steps to its optimum in ``lasso_work.fs_cold_kernel``'s
    formula, uncapped; X and D read once, Gamma written once.  Returns
    (flops, bytes)."""
    s = np.asarray(nnz, dtype=np.float64).ravel()
    N = s.size
    steps, _ = lasso_work.fs_cold_kernel(K, s.max(initial=0.0), s, 0)
    flops = 2.0 * p * K * N + steps
    return flops, F32 * (p * N + p * K + K * N)


def cold_starts(K, tun, block, nnz, n_lanes, n_atoms):
    """The K6 launches of an encode of n_lanes lanes in blocks of
    ``block`` (the last zero-padded: its padding lanes have no atom), each
    counted by ``lasso_work.fs_cold_kernel``; ``nnz`` is a sample of the
    lanes' nonzeros stood in for every block's real lanes, ``n_atoms`` the
    distinct atoms a block activates.  Returns (flops, bytes) of all the
    launches: the sample repeated to each block's real lanes."""
    nnz = np.asarray(nnz).ravel()
    flops = nbytes = 0.0
    for b in range(-(-n_lanes // block)):
        real = min(block, n_lanes - b * block)
        s = np.concatenate([np.resize(nnz, real), np.zeros(block - real)])
        f, n = lasso_work.fs_cold_kernel(K, tun, s, n_atoms)
        flops += f
        nbytes += n
    return flops, nbytes
