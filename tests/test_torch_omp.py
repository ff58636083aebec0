"""The port's OMP solvers and the plain version of its fused OMP kernel
against lyssandra_tpu: the Pallas kernel in interpret mode, the XLA scan
solvers on the CPU and the fp64 oracle (same float32 inputs from a numpy
seed)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from lyssandra_tpu import oracle
from lyssandra_tpu.ops.pallas_omp import omp_fused as pallas_omp_fused
from lyssandra_tpu.solvers import greedy as jgreedy
from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import cuda_omp, launch_counts
from lyssandra_tpu_torch.solvers import greedy
from tests.conftest import make_problem

torch.set_num_threads(1)

_HI = lax.Precision.HIGHEST


def _f32(rng, **kw):
    D, X, _ = make_problem(rng, **kw)
    return D.astype(np.float32), X.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_result_close(got, want, *, gamma_atol=2e-5, err_atol=2e-4,
                         mask_idx=False):
    """idx and nsel equal, gamma within 2e-5 and err within 2e-4 — the
    reference's own kernel-vs-scan tolerances (tests/test_pallas_omp.py)."""
    idx, gamma, err, nsel = (np.asarray(a) for a in got)
    widx, wgamma, werr, wnsel = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(nsel, wnsel)
    if mask_idx:
        keep = np.arange(idx.shape[1])[None, :] < wnsel[:, None]
        idx, widx = idx * keep, widx * keep
    np.testing.assert_array_equal(idx, widx)
    np.testing.assert_allclose(gamma, wgamma, atol=gamma_atol)
    np.testing.assert_allclose(err, werr, atol=err_atol)


# (problem, mode) cases of tests/test_pallas_omp.py: T mode; eps mode with
# half the lanes easy; eps mode where a whole 64-lane block is done on
# entry and the next one converges in about one step
@pytest.mark.parametrize("case", ["t_mode", "eps_mode", "eps_done_on_entry"])
def test_omp_fused_reference_matches_pallas_interpret(rng, case):
    if case == "t_mode":
        D, X = _f32(rng, p=16, K=128, N=1024, T=4)
        kw, block = dict(T=4), 512
    elif case == "eps_mode":
        D, X = _f32(rng, p=16, K=128, N=512, T=3)
        X[:, ::2] *= 0.05
        kw, block = dict(T=6, eps=0.3, eps_mode=True), 512
    else:
        D, X = _f32(rng, p=16, K=128, N=256, T=3)
        X[:, :64] *= 1e-6
        X[:, 64:128] *= 0.05
        kw, block = dict(T=6, eps=0.3, eps_mode=True), 64
    got = cuda_omp.omp_fused_reference(_t(D), _t(X), **kw)
    want = pallas_omp_fused(jnp.asarray(D), jnp.asarray(X), block=block,
                            interpret=True, **kw)
    _assert_result_close(got, want, mask_idx=case != "t_mode")
    if case == "eps_done_on_entry":
        assert (np.asarray(got[3])[:64] == 0).all()
        assert (np.asarray(got[1])[:64] == 0).all()


@pytest.mark.parametrize("eps_mode", [False, True])
def test_omp_impl_matches_jax(rng, eps_mode):
    D, X = _f32(rng, p=16, K=64, N=300, T=4)
    X[:, ::3] *= 0.1
    eps = 0.2 if eps_mode else 0.0
    got = greedy._omp_impl(_t(D), _t(X), eps, T=6, eps_mode=eps_mode)
    want = jgreedy._omp_impl(jnp.asarray(D), jnp.asarray(X), eps, T=6,
                             eps_mode=eps_mode, precision=_HI)
    _assert_result_close(got, want)


@pytest.mark.parametrize("eps_mode", [False, True])
def test_batch_omp_impl_matches_jax(rng, eps_mode):
    D, X = _f32(rng, p=16, K=64, N=300, T=4)
    X[:, ::3] *= 0.1
    eps = 0.2 if eps_mode else 0.0
    Dt, Xt = _t(D), _t(X)
    got = greedy._batch_omp_impl(Dt.T @ Dt, Dt.T, Xt.T @ Dt,
                                 (Xt * Xt).sum(0), eps, T=6,
                                 eps_mode=eps_mode)
    Dj, Xj = jnp.asarray(D), jnp.asarray(X)
    want = jgreedy._batch_omp_impl(
        jnp.matmul(Dj.T, Dj, precision=_HI), Dj.T,
        jnp.matmul(Xj.T, Dj, precision=_HI), jnp.sum(Xj * Xj, axis=0), eps,
        T=6, eps_mode=eps_mode, precision=_HI)
    _assert_result_close(got, want)


@pytest.mark.parametrize("refresh", ["auto", "gram", "residual"])
@pytest.mark.parametrize("eps", [None, 0.05])
def test_batch_omp_supports_match_oracle(rng, refresh, eps):
    D, X = _f32(rng, p=16, K=48, N=64, T=3)
    got = greedy.batch_omp(D, X, 5, eps, refresh=refresh,
                           device="cpu").numpy()
    want = oracle.batch_omp(D.astype(np.float64), X.astype(np.float64), 5,
                            eps)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # omp is the residual form of the same pursuit
    np.testing.assert_allclose(greedy.omp(D, X, 5, eps,
                                          device="cpu").numpy(), got,
                               atol=1e-4)


def test_duplicate_atoms_freeze(rng):
    # a duplicated atom breaks the progressive factor down (nu ~ 0): the
    # lane freezes with finite outputs, like the reference.  Lanes 0-7 are
    # 2 e_0 over atoms 0 and 64, both e_0: step 1 leaves r = 0 exactly,
    # step 2 re-picks atom 0 (all-zero correlations, first index wins)
    # and freezes.
    D, X, _ = make_problem(rng, p=16, K=128, N=256, T=4)
    D[:, 64:] = D[:, :64]
    D[:, 0] = D[:, 64] = np.eye(16)[0]
    X[:, :8] = 2.0 * np.eye(16)[:, :1]
    D, X = D.astype(np.float32), X.astype(np.float32)
    got = cuda_omp.omp_fused_reference(_t(D), _t(X), T=8)
    want = jgreedy._omp_impl(jnp.asarray(D), jnp.asarray(X), 0.0, T=8,
                             eps_mode=False, precision=_HI)
    assert np.isfinite(got[1].numpy()).all()
    np.testing.assert_array_equal(got[3].numpy()[:8], 1)
    np.testing.assert_array_equal(got[0].numpy()[:8], 0)
    np.testing.assert_array_equal(got[1].numpy()[:8, 0], 2.0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want.nsel))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want.gamma),
                               atol=5e-5)


def test_argmax_abs_first_index_wins_ties():
    A = torch.tensor([[1.0, -3.0, 3.0, 2.0],
                      [0.0, 0.0, 0.0, 0.0],
                      [-5.0, 1.0, 5.0, -5.0]])
    np.testing.assert_array_equal(greedy._argmax_abs(A).numpy(), [1, 0, 0])
    np.testing.assert_array_equal(
        greedy._argmax_abs(A).numpy(),
        np.asarray(jgreedy._argmax_abs(jnp.asarray(A.numpy()))))


def test_greedy_result_dense_csc_concatenate_match_jax(rng):
    N, T, K = 40, 5, 30
    idx = rng.integers(0, K, (N, T)).astype(np.int32)
    gamma = rng.standard_normal((N, T)).astype(np.float32)
    err = rng.random(N).astype(np.float32)
    nsel = rng.integers(0, T + 1, N).astype(np.int32)
    got = greedy.GreedyResult(_t(idx), _t(gamma), _t(err), _t(nsel))
    want = jgreedy.GreedyResult(*(jnp.asarray(a)
                                  for a in (idx, gamma, err, nsel)))
    np.testing.assert_allclose(got.dense(K).numpy(), np.asarray(want.dense(K)),
                               atol=1e-6)
    np.testing.assert_allclose(got.to_csc(K).toarray(),
                               want.to_csc(K).toarray(), atol=1e-6)
    both = greedy.GreedyResult.concatenate([got, got])
    assert tuple(both.idx.shape) == (2 * N, T)
    np.testing.assert_allclose(both.dense(K).numpy()[:, N:],
                               got.dense(K).numpy())


def test_wrapper_runs_plain_version_on_cpu_and_counts_nothing(rng):
    D, X = _f32(rng, p=12, K=100, N=100, T=4)
    before = launch_counts()
    got = cuda_omp.omp_fused(_t(D), _t(X), T=4)
    want = cuda_omp.omp_fused_reference(_t(D), _t(X), T=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    res = greedy._omp_fused_call(_t(D), _t(X), T=4, eps=0.0, eps_mode=False,
                                 dense=True)
    assert tuple(res.shape) == (100, 100)
    assert launch_counts() == before
    # the gate sends CPU tensors to the batched forms, never the kernel
    assert not greedy._fused_supported(_t(D), _t(X), 4)


def test_kernel_envelope():
    # the Gram-form lane state: x, alpha0, the T x T factor, six T-vectors;
    # the block adds a staging ring of D (two slices of 8 x 512 floats)
    assert cuda_omp.kernel_supports(64, 1024, 8)      # the bench shape
    assert cuda_omp.kernel_supports(64, 256, 10)      # the denoiser's K2
    assert cuda_omp.kernel_supports(512, 1024, 32)
    assert cuda_omp.kernel_supports(513, 1024, 8)     # no cap on p
    assert cuda_omp.kernel_supports(768, 256, 10)     # 16 x 16 colour
    assert not cuda_omp.kernel_supports(512, 1024, 200)  # exceeds smem
    assert not cuda_omp.kernel_supports(64, 65536, 8)
    assert not cuda_omp.kernel_supports(64, 1024, 0)
    assert cuda_omp.lane_smem_bytes(64, 1024, 8) == 4 * (64 + 1024 + 64 + 48)
    assert cuda_omp.lane_smem_bytes(64, 256, 10) == 4 * (64 + 256 + 100 + 60)
    assert cuda_omp.lane_smem_bytes(21, 99, 3) == 4 * (24 + 100 + 9 + 18)
    assert cuda_omp.lane_smem_bytes(13, 99, 3) == 4 * (16 + 100 + 9 + 18)
    assert cuda_omp.block_smem_bytes(64, 1024, 8, 16) == \
        4 * 8192 + 16 * 4800
    assert cuda_omp.block_lanes(64, 1024, 8) == 16
    assert cuda_omp.block_lanes(64, 256, 10) == 8     # K <= 256: at most 8
    assert cuda_omp.block_lanes(768, 256, 10) == 8
    assert cuda_omp.block_lanes(64, 257, 10) == 16
    assert cuda_omp.block_lanes(64, 8192, 8) == 4     # 33,472 bytes a lane
    for shape in ((64, 1024, 8), (768, 256, 10), (64, 8192, 8)):
        lanes = cuda_omp.block_lanes(*shape)
        assert cuda_omp.block_smem_bytes(*shape, lanes) <= \
            _build.SMEM_PER_BLOCK


@pytest.mark.parametrize("p, T, k_max", [(64, 8, 12304), (512, 32, 10752),
                                         (768, 10, 11552)])
def test_kernel_envelope_largest_k(monkeypatch, p, T, k_max):
    # alpha0 of every lane of a block lives in shared memory, so K has a
    # cap; above it batch_omp on the card takes the residual-form kernel
    # where p <= 512 (the reference's gate), else the residual-form
    # _omp_impl
    assert cuda_omp.kernel_supports(p, k_max, T)
    assert not cuda_omp.kernel_supports(p, k_max + 1, T)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    X = torch.empty((p, 4), device="meta")
    above = "residual" if p <= 512 else "plain"
    for K, route in ((k_max, "gram"), (k_max + 1, above)):
        D = torch.empty((p, K), device="meta")
        assert greedy._route_of(D, X, T) == route
        assert greedy._fused_supported(D, X, T) is (route != "plain")


@pytest.mark.parametrize("eps_mode", [False, True])
def test_omp_fused_launches_gram_once(monkeypatch, eps_mode):
    # The wrapper's CUDA route without a GPU: tensors on the meta device
    # posing as CUDA ones, a stand-in library that records its arguments,
    # and a stand-in product that counts on gram's own counter.  Each call
    # builds G once (symmetric) and launches the kernel once, so
    # launch_counts() shows both.
    import contextlib
    import types

    from lyssandra_tpu_torch.ops import _launch, reset_launch_counts

    calls = []

    def gram(A, B, *, symmetric=False):
        assert symmetric and B is A
        _launch.count("gram")
        return torch.empty((A.shape[1], A.shape[1]), device=A.device)

    lib = types.SimpleNamespace(
        lyssa_omp_fused=lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(cuda_omp, "gram", gram)
    monkeypatch.setattr(cuda_omp._build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    D = torch.empty((64, 256), device="meta")
    X = torch.empty((64, 1000), device="meta")
    reset_launch_counts()
    idx, gamma, err, nsel = cuda_omp.omp_fused(D, X, T=10, eps=2.0,
                                               eps_mode=eps_mode)
    counts = launch_counts()
    assert counts["gram"] == 1
    assert counts["omp_fused_eps" if eps_mode else "omp_fused_t"] == 1
    assert counts["omp_fused_t" if eps_mode else "omp_fused_eps"] == 0
    assert tuple(idx.shape) == (1000, 10) and tuple(err.shape) == (1000,)
    (args,) = calls
    # p, K, N, T, eps^2, eps_mode, lanes
    assert args[4:11] == (64, 256, 1000, 10, 4.0, int(eps_mode), 8)
    reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        cuda_omp.omp_fused(D, X, T=400)
    assert launch_counts()["gram"] == 0


def test_kernel_library_named_by_source_hash():
    # built only on first use, never at import: nothing here needs nvcc
    names = sorted(p.name for p in _build.sources())
    assert names == ["errors.cu", "fs_cold.cu", "fs_scan.cu",
                     "fused_patches.cu", "gram.cu", "group_omp.cu",
                     "omp_fused.cu", "omp_residual.cu", "select.cu"]
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert path.name.startswith("liblyssa_kernels_")


@pytest.mark.parametrize("route", ["omp", "batch_omp", "encoder"])
def test_corr_dtype_bf16_matches_jax(rng, route):
    """corr_dtype='bf16' rounds the selection product's operands to bf16
    and accumulates in float32, as the reference does.  Held by
    tests/test_greedy.py's rule: on a well-posed problem the supports agree
    with the reference's bf16 run on >= 99% of lanes, the codes within
    5e-4 there."""
    D, X = _f32(rng, p=64, K=256, N=512, T=8)
    kw = {"corr_dtype": "bf16"}
    if route == "encoder":
        from lyssandra_tpu_torch import SparseEncoder
        import lyssandra_tpu as jlt

        got = SparseEncoder("bomp", {"T": 8, **kw},
                            device="cpu").encode(X, D).numpy()
        want = np.asarray(jlt.SparseEncoder("bomp", {"T": 8, **kw}).encode(
            X, D))
    else:
        got = getattr(greedy, route)(_t(D), _t(X), 8, **kw).numpy()
        want = np.asarray(getattr(jgreedy, route)(jnp.asarray(D),
                                                  jnp.asarray(X), 8, **kw))
    same = ((np.abs(got) > 1e-12) == (np.abs(want) > 1e-12)).all(axis=0)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(got[:, same], want[:, same], atol=5e-4)
    # the bf16 selection really differs from the float32 one somewhere in
    # the correlations, yet picks the float32 supports on this problem
    hi = greedy.batch_omp(_t(D), _t(X), 8).numpy()
    assert ((np.abs(hi) > 1e-12) == (np.abs(got) > 1e-12)).all(
        axis=0).mean() >= 0.99


@pytest.mark.parametrize("route", ["omp", "batch_omp"])
def test_corr_dtype_rejects_unknown(rng, route):
    D, X = _f32(rng, p=16, K=32, N=8, T=2)
    with pytest.raises(ValueError, match="corr_dtype"):
        getattr(greedy, route)(_t(D), _t(X), 2, corr_dtype="fp16")
    # the fused kernel's gate declines bf16 selection products
    assert not greedy._fused_supported(_t(D), _t(X), 2, "bf16")
