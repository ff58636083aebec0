"""The port's product kernel wrapper (``ops/cuda_gram.gram``, C = A^T B, the
alpha0 = X^T D and G = D^T D that the Gram-form kernels start from) on the
CPU, where it runs its plain version: against a float64 numpy product and
against the reference's own product at HIGHEST precision (the same float32
inputs from a numpy seed), its argument checks and its launch counter.

Tolerance: each entry of C is a p-term float32 dot product, whose rounding
error is at most gamma_p = p 2^-24 / (1 - p 2^-24) times
sum_c |a_ci b_cj| <= ||a_i|| ||b_j||; two float32 products may each be
that far from the exact value, so they are held within twice that bound,
entry by entry."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.ops import _launch, cuda_gram

torch.set_num_threads(1)

_SHAPES = [(21, 500, 100), (512, 33, 7), (1, 1, 1), (64, 1000, 130),
           (192, 77, 1024), (576, 40, 96), (768, 9, 130)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gamma(p):
    u = 2.0 ** -24
    return p * u / (1.0 - p * u)


def _check_close(got, want, A, B):
    """|got - want| <= 2 gamma_p ||a_i|| ||b_j|| entry by entry."""
    scale = np.outer(np.linalg.norm(A.astype(np.float64), axis=0),
                     np.linalg.norm(B.astype(np.float64), axis=0))
    err = np.abs(np.asarray(got, np.float64) - want)
    assert np.all(err <= 2.0 * _gamma(A.shape[0]) * scale + 1e-30), (
        float((err / np.maximum(scale, 1e-30)).max()))


@pytest.mark.parametrize("p,M,K", _SHAPES)
def test_gram_cpu_route_matches_float64(rng, p, M, K):
    A = rng.standard_normal((p, M)).astype(np.float32)
    B = rng.standard_normal((p, K)).astype(np.float32)
    got = cuda_gram.gram(_t(A), _t(B))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, K)
    assert torch.equal(got, cuda_gram.gram_reference(_t(A), _t(B)))
    _check_close(got.numpy(), A.T.astype(np.float64) @ B, A, B)


@pytest.mark.parametrize("p,M,K", _SHAPES[:2])
def test_gram_matches_reference_product(rng, p, M, K):
    """alpha0 as the reference forms it, jnp.matmul(X.T, D) at HIGHEST."""
    A = rng.standard_normal((p, M)).astype(np.float32)
    B = rng.standard_normal((p, K)).astype(np.float32)
    want = jnp.matmul(jnp.asarray(A).T, jnp.asarray(B),
                      precision=lax.Precision.HIGHEST)
    _check_close(cuda_gram.gram(_t(A), _t(B)).numpy(), np.asarray(want),
                 A, B)


@pytest.mark.parametrize("p,K", [(1, 1), (21, 100), (64, 1024), (192, 77),
                                 (576, 130)])
def test_gram_symmetric_matches_full_product(rng, p, K):
    # G = A^T A from one triangle: equal to A.T @ A and symmetric
    A = rng.standard_normal((p, K)).astype(np.float32)
    At = _t(A)
    got = cuda_gram.gram(At, At, symmetric=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (K, K)
    assert torch.equal(got, cuda_gram.gram_reference(At, At))
    assert torch.equal(got, cuda_gram.gram(At, At))
    _check_close(got.numpy(), A.T.astype(np.float64) @ A, A, A)


@pytest.mark.parametrize("case", ["a copy of A", "another B"])
def test_gram_symmetric_needs_b_to_be_a(rng, case):
    A = _t(rng.standard_normal((8, 5)).astype(np.float32))
    B = A.clone() if case == "a copy of A" else _t(
        rng.standard_normal((8, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="symmetric"):
        cuda_gram.gram(A, B, symmetric=True)


@pytest.mark.parametrize("case", [
    "ndim", "p mismatch", "float64", "p = 0", "device"])
def test_gram_rejects_bad_arguments(case):
    A = torch.zeros(8, 5)
    B = torch.zeros(8, 3)
    if case == "ndim":
        A = torch.zeros(8)
    elif case == "p mismatch":
        B = torch.zeros(9, 3)
    elif case == "float64":
        A = A.double()
    elif case == "p = 0":
        A, B = torch.zeros(0, 5), torch.zeros(0, 3)
    else:  # a device with no kernel, and two devices
        with pytest.raises(ValueError, match="no kernel"):
            cuda_gram.gram(A.to("meta"), B.to("meta"))
        B = B.to("meta")
    with pytest.raises(ValueError):
        cuda_gram.gram(A, B)


def test_gram_counter_is_registered_and_cpu_counts_nothing(rng):
    lt.reset_launch_counts()
    assert lt.launch_counts()["gram"] == 0
    A = _t(rng.standard_normal((16, 40)).astype(np.float32))
    cuda_gram.gram(A, A)
    assert lt.launch_counts()["gram"] == 0
    for _ in range(3):
        _launch.count("gram")
    assert lt.launch_counts()["gram"] == 3
    lt.reset_launch_counts()
    assert lt.launch_counts()["gram"] == 0
