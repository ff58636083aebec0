"""The port's SparseEncoder front end against lyssandra_tpu's, route by
route, dense and compact, with block chunking and a ragged last block (the
``tiny`` problem of tests/test_api_surface.py, float32 from a numpy
seed)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lyssandra_tpu as jlt
from lyssandra_tpu.solvers import greedy as jgreedy
from lyssandra_tpu_torch import SparseEncoder, sparse_encoder, threshold_code
from lyssandra_tpu_torch.parallel import make_mesh
from lyssandra_tpu_torch.utils.interop import encoder_from_reference

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    """D (16, 32) unit-norm; X (16, 50) noisy 1-sparse signals (the first
    48 columns are those of tests/test_api_surface.py)."""
    rng = np.random.default_rng(7)
    D = rng.standard_normal((16, 32))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    X = D[:, rng.integers(0, 32, 48)] * rng.standard_normal(48) \
        + 0.01 * rng.standard_normal((16, 48))
    extra = rng.standard_normal((16, 2))
    return (D.astype(np.float32),
            np.concatenate([X, extra], axis=1).astype(np.float32))


GROUPS = np.repeat(np.arange(8), 4)
PORTED_ROUTES = [
    ("bomp", {"T": 3}),
    ("batch_omp", {"T": 3}),
    ("omp", {"T": 3}),
    ("group_omp", {"T": 2, "groups": GROUPS}),
    ("nn_omp", {"T": 3}),
    ("llc", {"knn": 3}),
    ("thresholding", {"lam": 0.1}),
    ("soft_thresholding", {"lam": 0.1}),
    ("hard_thresholding", {"lam": 0.1}),
    ("thresholding", {"lam": 0.1, "kind": "hard"}),
]
COMPACT_ROUTES = ["bomp", "batch_omp", "omp", "group_omp", "nn_omp"]


@pytest.mark.parametrize("N", [48, 50])
@pytest.mark.parametrize("block", [None, 16])
@pytest.mark.parametrize(
    "alg,params", PORTED_ROUTES,
    ids=[f"{a}-{p.get('kind', '')}" for a, p in PORTED_ROUTES])
def test_encoder_route_matches_jax(tiny, alg, params, block, N):
    D, X = tiny
    X = X[:, :N]
    got = SparseEncoder(alg, params, block=block, device="cpu").encode(X,
                                                                       D)
    want = np.asarray(jlt.SparseEncoder(alg, params, block=block).encode(
        X, D))
    assert tuple(got.shape) == (32, N)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    if alg not in COMPACT_ROUTES:
        return
    res = SparseEncoder(alg, params, block=block, device="cpu").encode(
        X, D, dense=False)
    jres = jlt.SparseEncoder(alg, params, block=block).encode(X, D,
                                                             dense=False)
    width = 8 if alg == "group_omp" else 3          # T * gs slots, or T
    assert tuple(res.idx.shape) == (N, width)
    assert tuple(res.gamma.shape) == (N, width)
    np.testing.assert_array_equal(res.nsel.numpy(), np.asarray(jres.nsel))
    np.testing.assert_allclose(res.err.numpy(), np.asarray(jres.err),
                               atol=2e-4)
    # compact exports equal the dense route
    np.testing.assert_allclose(res.dense(32).numpy(), got.numpy(), atol=1e-6)
    np.testing.assert_allclose(res.to_csc(32).toarray(), got.numpy(),
                               atol=1e-6)


def test_check_atoms_rejects_non_unit_atoms(tiny):
    D, X = tiny
    with pytest.raises(ValueError) as got:
        SparseEncoder("bomp", {"T": 3}, device="cpu").encode(X, 2.0 * D)
    with pytest.raises(ValueError) as want:
        jlt.SparseEncoder("bomp", {"T": 3}).encode(X, 2.0 * D)
    assert str(got.value) == str(want.value)
    assert "unit-norm" in str(got.value)
    # within atol 1e-3 passes; check_atoms=False skips the check
    SparseEncoder("bomp", {"T": 3}, device="cpu").encode(X, 1.0005 * D)
    SparseEncoder("bomp", {"T": 3}, check_atoms=False,
                  device="cpu").encode(X, 2.0 * D)


def test_compact_rejects_thresholding(tiny):
    D, X = tiny
    with pytest.raises(ValueError, match="dense=False"):
        SparseEncoder("thresholding", {"lam": 0.1}, device="cpu").encode(
            X, D, dense=False)


@pytest.mark.parametrize("alg", ["lars", "lasso_lars"])
def test_unported_routes_raise(tiny, alg):
    # the LARS routes code (tests/test_torch_lars.py holds them to the
    # reference), and with a mesh they code each whole block on its first
    # slot; a mesh that is not a Mesh raises
    D, X = tiny
    G = SparseEncoder(alg, {"lam": 0.2}, device="cpu").encode(X, D)
    assert G.shape == (D.shape[1], X.shape[1]) and torch.isfinite(G).all()
    with pytest.raises(TypeError, match="Mesh"):
        SparseEncoder(alg, {"lam": 0.2}, mesh=object())
    mesh = make_mesh(devices=["cpu"] * 4)
    Gm = SparseEncoder(alg, {"lam": 0.2}, mesh=mesh).encode(X, D)
    np.testing.assert_array_equal(Gm.numpy(), G.numpy())


def test_unknown_route_and_mesh_raise(tiny):
    D, X = tiny
    with pytest.raises(ValueError, match="unknown algorithm: nope"):
        SparseEncoder("nope", device="cpu").encode(X, D)
    with pytest.raises(TypeError, match="Mesh"):
        SparseEncoder("bomp", {"T": 3}, mesh=object())
    mesh = make_mesh(devices=["cpu"] * 3)
    enc = SparseEncoder("bomp", {"T": 3}, mesh=mesh)
    assert enc.mesh is mesh and enc.device == torch.device("cpu")
    assert torch.equal(enc.encode(X, D), SparseEncoder(
        "bomp", {"T": 3}, device="cpu").encode(X, D))
    assert SparseEncoder("bomp").block == 16384
    assert SparseEncoder("lasso").block == 2048
    assert sparse_encoder("omp", {"T": 2}, block=8).block == 8


def test_omp_route_takes_fused_keyword(tiny):
    # the reference's omp takes fused=False (force the scan); the encoder
    # forwards params, so the port's omp must take it too
    D, X = tiny
    params = {"T": 3, "fused": False}
    got = SparseEncoder("omp", params, device="cpu").encode(X, D)
    want = np.asarray(jlt.SparseEncoder("omp", params).encode(X, D))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("extra", [
    {"packed": False, "interpret": True},
    {"packed": True, "interpret": False, "precision": None},
])
def test_group_omp_route_takes_reference_keywords(tiny, extra):
    # the reference's group_omp takes packed=, interpret= and precision=
    # (TPU variants of one computation); the port accepts and ignores them
    D, X = tiny
    params = {"T": 2, "groups": GROUPS}
    want = SparseEncoder("group_omp", params, device="cpu").encode(X, D)
    got = SparseEncoder("group_omp", {**params, **extra},
                        device="cpu").encode(X, D)
    assert torch.equal(got, want)
    ref = np.asarray(jlt.SparseEncoder(
        "group_omp", {**params, "packed": False}).encode(X, D))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_threshold_code_matches_jax(tiny, kind):
    D, X = tiny
    got = threshold_code(D, X, 0.3, kind, device="cpu")
    want = np.asarray(jgreedy.threshold_code(jnp.asarray(D), jnp.asarray(X),
                                             0.3, kind))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert (got.numpy() == 0).any()


def test_encoder_from_reference(tiny):
    D, X = tiny
    ref = jlt.SparseEncoder(
        "group_omp", {"T": np.int64(2), "groups": jnp.asarray(GROUPS)},
        block=16)
    enc = encoder_from_reference(ref.algorithm, ref.params, block=ref.block,
                                 check_atoms=ref.check_atoms, device="cpu")
    assert isinstance(enc.params["groups"], np.ndarray)
    assert type(enc.params["T"]) is int
    np.testing.assert_allclose(enc.encode(X, D).numpy(),
                               np.asarray(ref.encode(X, D)), atol=1e-4)
