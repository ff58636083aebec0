"""The port's non-negative OMP against lyssandra_tpu on the CPU: each of
the two forms (the scan and the unrolled steps, which round differently)
against its JAX twin, the T=0 empty code, and the fp64 oracle's
reconstruction criterion (the same float32 inputs from a numpy seed).

Tolerances: idx and nsel equal, codes within 2e-5 and err within 2e-4 —
tests/test_greedy.py's between the two forms, which is float32 solver
tolerance; against the oracle tests/test_greedy.py's reconstruction
criterion (supports may differ on marginal atoms)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lyssandra_tpu import oracle
from lyssandra_tpu.solvers import greedy as jgreedy
import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.solvers import greedy
from tests.conftest import make_problem

torch.set_num_threads(1)


def _nonneg_problem(rng, p, K, N, T):
    D, X, _ = make_problem(rng, p=p, K=K, N=N, T=T)
    return D.astype(np.float32), np.abs(X).astype(np.float32)


@pytest.mark.parametrize("nnls_rounds", [1, 4])
@pytest.mark.parametrize("unroll", [True, False], ids=["unrolled", "scan"])
def test_nn_omp_form_matches_jax_twin(rng, unroll, nnls_rounds):
    D, X = _nonneg_problem(rng, 32, 96, 64, 8)
    kw = dict(dense=False, unroll=unroll, nnls_rounds=nnls_rounds)
    got = greedy.nn_omp(torch.from_numpy(D), torch.from_numpy(X), 8, **kw)
    want = jgreedy.nn_omp(jnp.asarray(D), jnp.asarray(X), 8, **kw)
    np.testing.assert_array_equal(got.nsel.numpy(), np.asarray(want.nsel))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               atol=2e-5)
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err),
                               atol=2e-4)
    assert (got.gamma.numpy() >= 0).all()


def test_nn_omp_forms_agree(rng):
    # tests/test_greedy.py's rule between the two forms: exact nsel and idx
    # on lanes whose residual stays non-negligible
    D, X = _nonneg_problem(rng, 32, 96, 64, 8)
    a = greedy.nn_omp(D, X, 8, dense=False, unroll=False, device="cpu")
    b = greedy.nn_omp(D, X, 8, dense=False, unroll=True, device="cpu")
    generic = a.err.numpy() > 1e-6
    np.testing.assert_array_equal(a.nsel.numpy()[generic],
                                  b.nsel.numpy()[generic])
    np.testing.assert_array_equal(a.idx.numpy()[generic],
                                  b.idx.numpy()[generic])
    np.testing.assert_allclose(a.dense(96).numpy(), b.dense(96).numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(a.err.numpy(), b.err.numpy(), atol=2e-4)


def test_nn_omp_matches_oracle(rng):
    D, X, _ = make_problem(rng, p=16, K=48, N=24, T=4)
    Xp = np.abs(X)
    ref = oracle.nn_omp(D, Xp, 4)
    out = lt.nn_omp(D.astype(np.float32), Xp.astype(np.float32), 4,
                    device="cpu").numpy().astype(np.float64)
    assert (out >= 0).all()
    r_ref = np.linalg.norm(Xp - D @ ref, axis=0)
    r_out = np.linalg.norm(Xp - D @ out, axis=0)
    assert (r_out <= r_ref + 0.05 * np.linalg.norm(Xp, axis=0)).all()


@pytest.mark.parametrize("unroll", [None, True, False])
def test_nn_omp_T0(rng, unroll):
    D, X = _nonneg_problem(rng, 16, 48, 24, 4)
    res = greedy.nn_omp(D, X, 0, dense=False, unroll=unroll, device="cpu")
    want = jgreedy.nn_omp(jnp.asarray(D), jnp.asarray(X), 0, dense=False,
                          unroll=unroll)
    assert tuple(res.idx.shape) == (24, 0)
    np.testing.assert_allclose(res.err.numpy(), np.asarray(want.err),
                               rtol=1e-6)
    assert not greedy.nn_omp(D, X, 0, device="cpu").any()
