"""The port's masked OMP and inpainting against lyssandra_tpu on the CPU and
the fp64 oracle (the same float32 inputs and masks from a numpy seed).

Tolerances: against the oracle tests/test_inpaint.py's 5e-4 on the codes
(float32 against float64); against the JAX package, which runs the same
float32 algorithm, idx and nsel equal and codes within 2e-5 (the solver
tolerance of tests/test_pallas_omp.py); the inpainted image within 1e-3
grey levels of the JAX one (pixel values up to about 255, float32)."""

import numpy as np
import pytest
import torch

from lyssandra_tpu import oracle
from lyssandra_tpu.apps import inpaint as jinpaint
from lyssandra_tpu.ops import dct_dictionary as j_dct_dictionary
from lyssandra_tpu.solvers import greedy as jgreedy
import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.apps import inpaint
from lyssandra_tpu_torch.solvers import greedy, masked_omp
from lyssandra_tpu_torch.utils.datasets import synthetic_image
from tests.conftest import make_problem

torch.set_num_threads(1)


@pytest.mark.parametrize("eps", [None, 0.2], ids=["T", "eps"])
def test_masked_omp_matches_jax_and_oracle(rng, eps):
    D, X, _ = make_problem(rng, p=16, K=48, N=96, T=3)
    M = (rng.uniform(size=X.shape) > 0.3).astype(np.float64)
    M[:, 0] = 1.0                       # one fully observed lane
    M[:, 1] = 0.0                       # one lane with nothing observed
    T = 3 if eps is None else 6
    Df, Xf, Mf = (a.astype(np.float32) for a in (D, X, M))
    got = masked_omp(Df, Xf, Mf, T, eps, dense=False, device="cpu")
    want = jgreedy.masked_omp(Df, Xf, Mf, T, eps, dense=False)
    np.testing.assert_array_equal(got.nsel.numpy(), np.asarray(want.nsel))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma),
                               atol=2e-5)
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err),
                               atol=2e-4)
    ref = oracle.masked_omp(D, X, M, T, eps=eps)
    np.testing.assert_allclose(got.dense(48).numpy(), ref, atol=5e-4)


def test_masked_omp_full_mask_equals_omp(rng):
    D, X, _ = make_problem(rng, p=16, K=48, N=64, T=4)
    D, X = D.astype(np.float32), X.astype(np.float32)
    a = masked_omp(D, X, np.ones_like(X), 4, device="cpu").numpy()
    b = lt.omp(D, X, 4, device="cpu").numpy()
    np.testing.assert_allclose(a, b, atol=2e-5)


@pytest.mark.parametrize("keep_known", [True, False])
def test_inpaint_matches_jax(rng, keep_known):
    img = synthetic_image("smooth", 64, seed=3)
    mask = (rng.uniform(size=img.shape) > 0.25).astype(np.float64)
    corrupted = img * mask
    D = lt.dct_dictionary(8, 64, device="cpu")
    out = inpaint(corrupted, mask, D, T=6, keep_known=keep_known)
    assert out.device.type == "cpu" and tuple(out.shape) == img.shape
    want = np.asarray(jinpaint(corrupted, mask, j_dct_dictionary(8, 64),
                               T=6, keep_known=keep_known))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-3)
    miss = mask == 0
    err_before = np.abs(corrupted - img)[miss].mean()
    err_after = np.abs(out.numpy() - img)[miss].mean()
    assert err_after < 0.25 * err_before, (err_before, err_after)
    if keep_known:
        np.testing.assert_allclose(out.numpy()[mask > 0], img[mask > 0],
                                   atol=1e-4)


def test_inpaint_exports():
    from lyssandra_tpu_torch import apps, solvers

    assert apps.inpaint is inpaint
    assert solvers.masked_omp is greedy.masked_omp
    assert lt.nn_omp is greedy.nn_omp
