"""The port's feature-sign lasso coder, FISTA and the plain version of its
fused cold-start kernel against lyssandra_tpu on the CPU: the same float32
inputs from a numpy seed; the reference's Pallas cold-start kernel runs in
interpret mode, as tests/test_pallas_fs.py runs it.

Tolerances: cold-start states as tests/test_pallas_fs.py holds the kernel
to the XLA form (bool and int fields equal, float fields within 1e-5);
lasso solutions as tests/test_lasso.py holds them to the oracle
(objectives within rtol 1e-4, atol 1e-5; codes within 2e-3); FISTA within
1e-4."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lyssandra_tpu as jlt
from lyssandra_tpu import oracle
from lyssandra_tpu.utils.datasets import patch_dataset as j_patch_dataset
from lyssandra_tpu.utils.datasets import (
    synthetic_color_image as j_synthetic_color,
)
import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.ops import cuda_fs
from lyssandra_tpu_torch.ops.cuda_fs import (
    fs_cold_fused,
    kernel_supports,
    lane_smem_bytes,
)
from lyssandra_tpu_torch.utils.datasets import (
    patch_dataset,
    synthetic_color_image,
)
from lyssandra_tpu_torch.utils.interop import encoder_from_reference
from tests.conftest import make_problem

jl = importlib.import_module("lyssandra_tpu.solvers.lasso")
tl = importlib.import_module("lyssandra_tpu_torch.solvers.lasso")

torch.set_num_threads(1)

_HI = jax.lax.Precision.HIGHEST
_STATE = ["idx", "mask", "theta", "gact", "gr", "done", "ovf", "t"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _objective(D, X, G, lam):
    R = X.astype(np.float64) - D.astype(np.float64) @ G.astype(np.float64)
    return (R * R).sum(axis=0) + lam * np.abs(G.astype(np.float64)).sum(
        axis=0)


def _assert_solution_close(D, X, got, want, lam):
    np.testing.assert_allclose(_objective(D, X, got, lam),
                               _objective(D, X, want, lam),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-3)


def _assert_state_equal(got, want):
    """A port state tuple against a reference one: bool and int fields
    equal, float fields within 1e-5."""
    for name, a, b in zip(_STATE, want, got):
        a = np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def coherent():
    """tests/test_pallas_fs.py's problem: p=24, K=96 with a coherent atom
    pair, 64 unit-norm noisy 3-sparse signals."""
    rng = np.random.default_rng(1)
    p, K, N = 24, 96, 64
    D = rng.standard_normal((p, K))
    D[:, 50] = D[:, 10] + 0.01 * rng.standard_normal(p)
    D /= np.linalg.norm(D, axis=0)
    idx0 = rng.integers(0, K, (N, 3))
    X = np.zeros((p, N))
    for j in range(3):
        X += D[:, idx0[:, j]] * rng.standard_normal(N)
    X += 0.05 * rng.standard_normal((p, N))
    X /= np.linalg.norm(X, axis=0)
    return D.astype(np.float32), X.astype(np.float32)


@pytest.fixture(scope="module")
def unaligned():
    """p=21, K=100 (off the TPU's tiles), 48 unit-norm Gaussian signals."""
    rng = np.random.default_rng(7)
    D = rng.standard_normal((21, 100))
    D /= np.linalg.norm(D, axis=0)
    X = rng.standard_normal((21, 48))
    X /= np.linalg.norm(X, axis=0)
    return D.astype(np.float32), X.astype(np.float32)


@pytest.fixture(scope="module")
def sparse():
    """tests/test_lasso.py's KKT problem: p=16, K=48, 32 noisy 4-sparse
    signals."""
    D, X, _ = make_problem(np.random.default_rng(0), p=16, K=48, N=32, T=4)
    return D.astype(np.float32), X.astype(np.float32)


def _j(a):
    return jnp.asarray(a, jnp.float32)


@pytest.mark.parametrize("lam", [0.05, 0.15])
def test_unrolled_state_matches_jax(coherent, lam):
    D, X = coherent
    want = jl._fs_unrolled_state(
        _j(D).T, _j(X).T, jnp.matmul(_j(X).T, _j(D), precision=_HI), lam,
        t_unroll=6, n_refine=2, max_active=16)
    Dt, Xt = _t(D), _t(X)
    got = tl._fs_unrolled_state(Dt.T, Xt.T, Xt.T @ Dt, lam, t_unroll=6,
                                n_refine=2, max_active=16)
    _assert_state_equal(got, want)


@pytest.mark.parametrize("case", ["coherent", "unaligned"])
def test_fs_cold_fused_matches_pallas_interpret(request, case):
    """fs_cold_fused on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode, through both packages' handoff to the plain
    loop."""
    D, X = request.getfixturevalue(case)
    lam, tun, A, block = ((0.15, 6, 16, 32) if case == "coherent"
                          else (0.1, 4, 12, 16))
    want = jl._fs_unrolled_state_fused(
        _j(D).T, _j(X).T, jnp.matmul(_j(X).T, _j(D), precision=_HI), lam,
        t_unroll=tun, n_refine=2, max_active=A, block=block)
    Dt, Xt = _t(D), _t(X)
    # feature_sign's handoff to the plain loop: the state padded to A slots
    got = tl._pad_handoff(*fs_cold_fused(Dt, Xt, lam=lam, t_unroll=tun),
                          max_active=A)
    _assert_state_equal(got, want)
    idx, mask, theta, gact, gr, done = fs_cold_fused(Dt, Xt, lam=lam,
                                                     t_unroll=tun)
    assert tuple(idx.shape) == (X.shape[1], tun)
    assert idx.dtype == torch.int32 and mask.dtype == torch.bool
    # the handoff gradient is zero at the active slots
    assert bool((gr.gather(1, idx.long())[mask] == 0).all())


FS_OPTIONS = [
    {},
    {"warm_start": 0},
    {"warm_seed": "fista"},
    {"cold_unroll": 6, "cold_backend": "xla"},
    {"cold_unroll": 6, "cold_backend": "pallas"},
    {"n_activate": 4},
]


@pytest.mark.parametrize("kw", FS_OPTIONS,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items())
                              or "defaults" for kw in FS_OPTIONS])
def test_feature_sign_matches_jax(sparse, kw):
    D, X = sparse
    lam = 0.15
    want = jl.feature_sign(_j(D), _j(X), lam, full_result=True, **kw)
    got = lt.feature_sign(D, X, lam, full_result=True, device="cpu", **kw)
    assert tuple(got.Gamma.shape) == (48, 32)
    _assert_solution_close(D, X, got.Gamma.numpy(), np.asarray(want.Gamma),
                           lam)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


def test_feature_sign_compact_stragglers_matches_jax(monkeypatch):
    """tests/test_lasso.py's mixed problem (easy sparse lanes and hard dense
    ones), so that stragglers remain after the first segment and are
    gathered into a narrow batch."""
    rng = np.random.default_rng(0)
    D, Xe, _ = make_problem(rng, p=16, K=48, N=40, T=2)
    X = np.concatenate([Xe, 2.0 * rng.standard_normal((16, 24))], axis=1)
    D, X = D.astype(np.float32), X.astype(np.float32)
    lam = 0.1
    gathers = []
    real = tl._gather_lanes
    monkeypatch.setattr(tl, "_gather_lanes",
                        lambda *a: gathers.append(1) or real(*a))
    got = lt.feature_sign(D, X, lam, max_iter=48, compact_stragglers=True,
                          warm_start=0, full_result=True, device="cpu")
    assert gathers
    want = jl.feature_sign(_j(D), _j(X), lam, max_iter=48,
                           compact_stragglers=True, warm_start=0,
                           full_result=True)
    _assert_solution_close(D, X, got.Gamma.numpy(), np.asarray(want.Gamma),
                           lam)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


def test_feature_sign_auto_capacity_resolves_overflow():
    """At lam=0.01 the solutions of a p=32, K=64 problem hold more than 16
    atoms, so the 16-slot run overflows and auto_capacity re-solves those
    lanes at max_active."""
    D, X, _ = make_problem(np.random.default_rng(3), p=32, K=64, N=24, T=12)
    D, X = D.astype(np.float32), X.astype(np.float32)
    lam = 0.01
    narrow = lt.feature_sign(D, X, lam, max_active=16, polish=False,
                             full_result=True, device="cpu")
    assert bool(narrow.overflow.any())
    want = jl.feature_sign(_j(D), _j(X), lam, auto_capacity=True,
                           full_result=True)
    got = lt.feature_sign(D, X, lam, auto_capacity=True, full_result=True,
                          device="cpu")
    _assert_solution_close(D, X, got.Gamma.numpy(), np.asarray(want.Gamma),
                           lam)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


def test_feature_sign_zero_solution(sparse):
    D, X = sparse
    lam = 1e3      # lam > 2 max |D^T x|: g = 0 is optimal
    want = jl.feature_sign(_j(D), _j(X), lam, full_result=True)
    got = lt.feature_sign(D, X, lam, full_result=True, device="cpu")
    assert bool((got.Gamma == 0).all())
    assert (np.asarray(want.Gamma) == 0).all()
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))


def test_feature_sign_matches_oracle():
    D, X, _ = make_problem(np.random.default_rng(0), p=16, K=32, N=24, T=3)
    lam = 0.2
    got = lt.lasso(D, X, lam, device="cpu").numpy()
    _assert_solution_close(D, X, got, oracle.lasso(D, X, lam), lam)


def test_feature_sign_kkt_and_host_syncs(sparse):
    """tests/test_lasso.py's KKT check; the loop's exit checks are counted
    as host syncs."""
    D, X = sparse
    lam = 0.15
    before = tl.host_syncs()
    res = lt.feature_sign(D, X, lam, warm_start=0, full_result=True,
                          device="cpu")
    assert tl.host_syncs() > before
    assert bool(res.done.all()) and not bool(res.overflow.any())
    G = res.Gamma.numpy().astype(np.float64)
    gr = 2 * (D.T @ (D @ G - X))
    act = np.abs(G) > 1e-10
    assert np.abs(gr + lam * np.sign(G))[act].max() < 1e-3
    assert (np.abs(gr[~act]) <= lam + 1e-3).all()


def test_feature_sign_rejects_bad_arguments(sparse):
    D, X = sparse
    with pytest.raises(ValueError, match="max_iter"):
        lt.feature_sign(D, X, 0.15, max_iter=0, device="cpu")
    with pytest.raises(ValueError, match="cold_backend"):
        lt.feature_sign(D, X, 0.15, cold_backend="mosaic", device="cpu")
    with pytest.raises(ValueError, match="warm_seed"):
        lt.feature_sign(D, X, 0.15, warm_seed="lars", device="cpu")


@pytest.mark.parametrize("n_iter", [50, 200])
def test_fista_matches_jax(sparse, n_iter):
    D, X = sparse
    want = np.asarray(jl.fista(_j(D), _j(X), 0.15, n_iter=n_iter))
    got = lt.fista(D, X, 0.15, n_iter=n_iter, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    """tests/test_torch_encoder.py's problem: D (16, 32), 48 noisy 1-sparse
    signals and 2 Gaussian ones."""
    rng = np.random.default_rng(7)
    D = rng.standard_normal((16, 32))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    X = D[:, rng.integers(0, 32, 48)] * rng.standard_normal(48) \
        + 0.01 * rng.standard_normal((16, 48))
    extra = rng.standard_normal((16, 2))
    return (D.astype(np.float32),
            np.concatenate([X, extra], axis=1).astype(np.float32))


@pytest.mark.parametrize("N", [48, 50])
@pytest.mark.parametrize("block", [None, 16])
@pytest.mark.parametrize("alg", ["lasso", "feature_sign", "fss", "fista"])
def test_encoder_convex_routes_match_jax(tiny, alg, block, N):
    D, X = tiny
    X = X[:, :N]
    params = {"lam": 0.2}
    got = lt.SparseEncoder(alg, params, block=block,
                           device="cpu").encode(X, D).numpy()
    want = np.asarray(jlt.SparseEncoder(alg, params, block=block).encode(
        X, D))
    assert got.shape == (32, N)
    if alg == "fista":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        _assert_solution_close(D, X, got, want, 0.2)


def test_encoder_from_reference_lasso(tiny):
    D, X = tiny
    ref = jlt.SparseEncoder(
        "lasso", {"lam": np.float32(0.2), "cold_unroll": np.int64(4),
                  "cold_backend": "xla", "max_active": 16}, block=16)
    enc = encoder_from_reference(ref.algorithm, ref.params, block=ref.block,
                                 check_atoms=ref.check_atoms, device="cpu")
    assert type(enc.params["lam"]) is float
    assert type(enc.params["cold_unroll"]) is int
    _assert_solution_close(D, X, enc.encode(X, D).numpy(),
                           np.asarray(ref.encode(X, D)), 0.2)


def test_cold_kernel_envelope():
    """The fused kernel's shape gate: config 4 at the default depth fits
    (8,112 bytes of shared memory per lane in the Gram form: the compact
    Gram, the broadcast vectors, a bit per atom and the alpha0 row), and
    so do 24x24 patches and 16x16 colour patches, since p sets no shared
    memory; a depth past 32 slots or an alpha0 row past shared memory does
    not; CPU tensors never take the kernel."""
    assert lane_smem_bytes(1024, 28) == 8112
    assert kernel_supports(192, 1024, 28)
    assert kernel_supports(21, 100, 1)
    assert kernel_supports(576, 1024, 28)
    assert kernel_supports(768, 1024, 28)
    assert not kernel_supports(192, 1024, 33)
    assert not kernel_supports(192, 1024, 0)
    assert not kernel_supports(4096, 65536, 32)
    D = torch.ones(8, 16)
    assert not cuda_fs.takes(D, torch.ones(8, 4), 4)


def test_lasso_exports():
    from lyssandra_tpu_torch import solvers

    assert lt.lasso is lt.feature_sign is solvers.feature_sign
    assert lt.feature_sign is tl.feature_sign and lt.fista is tl.fista
    assert solvers.FeatureSignResult is tl.FeatureSignResult


@pytest.mark.parametrize("kind", ["smooth", "texture", "edges", "mix"])
def test_synthetic_color_image_matches_reference(kind):
    np.testing.assert_array_equal(synthetic_color_image(kind, 40, seed=3),
                                  j_synthetic_color(kind, 40, seed=3))


@pytest.mark.parametrize("remove_dc", [True, False])
def test_patch_dataset_matches_reference(remove_dc):
    imgs = [synthetic_color_image(k, 32, seed=s)
            for s, k in enumerate(("texture", "mix"))]
    imgs.append(imgs[0][..., 0])        # a grey image among colour ones
    got = patch_dataset(imgs[:2], p=8, n_patches=301, seed=1,
                        remove_dc=remove_dc)
    want = j_patch_dataset(imgs[:2], p=8, n_patches=301, seed=1,
                           remove_dc=remove_dc)
    assert got.shape == (192, 301)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        patch_dataset([imgs[2]], p=4, n_patches=50, seed=2),
        j_patch_dataset([imgs[2]], p=4, n_patches=50, seed=2))
