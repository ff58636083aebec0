"""The port's locality-constrained linear coding against lyssandra_tpu on
the CPU and a float64 solve of the same system (the same float32 inputs
from a numpy seed).

Tolerances: the k-NN support equal exactly, ties included; codes within
2e-5 of the JAX package and of the float64 solve where the (k, k) system
is well conditioned (float32 CG or LU against the same algorithm); within
1e-3 where duplicate atoms make it singular up to the lam tr(C) ridge
(condition number about 1/lam = 1e4, so float32 rounding of 6e-8 grows to
about 6e-4; both float32 packages sit 1.2e-4 from the float64 solve)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lyssandra_tpu.solvers.llc import llc as jllc
import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.solvers.llc import llc

torch.set_num_threads(1)


def _problem(seed, p, K, N, duplicate=False):
    """Unit-norm Gaussian atoms and signals; with ``duplicate`` the second
    half of the atoms repeats the first, so every neighbour ties."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((p, K))
    if duplicate:
        D[:, K // 2:] = D[:, :K // 2]
    D /= np.linalg.norm(D, axis=0)
    X = rng.standard_normal((p, N))
    X /= np.linalg.norm(X, axis=0)
    return D.astype(np.float32), X.astype(np.float32)


def _float64_codes(D, X, idx, lam):
    D, X = D.astype(np.float64), X.astype(np.float64)
    out = []
    for n in range(X.shape[1]):
        z = D[:, idx[n]].T - X[:, n][None, :]
        C = z @ z.T
        C += (lam * np.trace(C) + 1e-12) * np.eye(len(idx[n]))
        c = np.linalg.solve(C, np.ones(len(idx[n])))
        out.append(c / c.sum())
    return np.array(out)


# knn <= 16 runs the unrolled CG, knn > 16 torch.linalg.solve
SHAPES = {5: (16, 64), 20: (32, 96)}


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "compact"])
@pytest.mark.parametrize("knn", [5, 20], ids=["cg", "solve"])
def test_llc_matches_jax(knn, dense):
    p, K = SHAPES[knn]
    D, X = _problem(0, p, K, 128)
    got = llc(torch.from_numpy(D), torch.from_numpy(X), knn, dense=dense)
    want = jllc(jnp.asarray(D), jnp.asarray(X), knn, dense=dense)
    if dense:
        assert tuple(got.shape) == (K, 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(got.sum(dim=0).numpy(), 1.0, atol=1e-5)
        return
    idx, c = got
    assert idx.dtype == torch.int32 and tuple(c.shape) == (128, knn)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(c.numpy(), np.asarray(want[1]), atol=2e-5)


@pytest.mark.parametrize("knn", [4, 20], ids=["cg", "solve"])
def test_llc_top_k_ties_match_jax(knn):
    """Duplicate atoms tie exactly: lax.top_k lists the lower index first,
    and so must the port (torch.topk promises no order among ties)."""
    p, K = (16, 64) if knn == 4 else (32, 96)
    D, X = _problem(1, p, K, 128, duplicate=True)
    idx, c = llc(D, X, knn, dense=False, device="cpu")
    widx, wc = jllc(jnp.asarray(D), jnp.asarray(X), knn, dense=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    # each neighbour comes with its duplicate, the lower index first
    first, second = idx.numpy()[:, 0::2], idx.numpy()[:, 1::2]
    np.testing.assert_array_equal(second, first + K // 2)
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), atol=1e-3)


def test_llc_matches_float64_solve():
    D, X = _problem(2, 16, 64, 96)
    idx, c = lt.llc(D, X, 5, lam=1e-3, dense=False, device="cpu")
    # the support is the knn atoms of largest d.x, in descending order
    sim = (X.T.astype(np.float64) @ D.astype(np.float64))
    np.testing.assert_array_equal(
        idx.numpy(), np.argsort(-sim, axis=1, kind="stable")[:, :5])
    np.testing.assert_allclose(c.numpy(),
                               _float64_codes(D, X, idx.numpy(), 1e-3),
                               atol=2e-5)
    np.testing.assert_allclose(c.sum(dim=1).numpy(), 1.0, atol=1e-5)
