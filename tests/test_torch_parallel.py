"""The port's device mesh (``lyssandra_tpu_torch.parallel`` and every
``mesh=``) against lyssandra_tpu on the CPU, case by case with
tests/test_parallel.py.

The reference runs on its eight virtual CPU devices (tests/conftest.py);
the port on ``make_mesh(devices=["cpu"] * 8)``, eight slots of the one CPU
device.  Both get the same float32 inputs from ``make_problem``.
Tolerances are test_parallel.py's: codes 2e-5 (sharded encode), D 1e-5 and
Gamma 1e-4 (one K-SVD step), D 2e-4 and Gamma 2e-3 (a 3-iteration fit),
1e-5 and nsel equal (atom-sharded OMP); the online fit 2e-3
(tests/test_dict_learning.py's).  The reference's two slow cases are held
against its unsharded call, so the JAX side never compiles its slow
sharded path.  Sharded against unsharded within the port: the same values,
since every per-slot route here is lane-independent (1e-6 where the CPU's
products over different widths may round differently)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lyssandra_tpu_torch as lt
from lyssandra_tpu.config import MeshConfig as JMeshConfig
from lyssandra_tpu.config import KSVDConfig as JKSVDConfig
from lyssandra_tpu.config import OnlineDLConfig as JOnlineDLConfig
from lyssandra_tpu.dict_learning import KSVDLearner as JKSVDLearner
from lyssandra_tpu.dict_learning import OnlineDictionaryLearner as JOnline
from lyssandra_tpu.dict_learning.online import OnlineDLState as JOnlineDLState
from lyssandra_tpu.parallel import ksvd_train_step as j_ksvd_train_step
from lyssandra_tpu.parallel import make_mesh as j_make_mesh
from lyssandra_tpu.parallel import sharded_ksvd_step as j_sharded_ksvd_step
from lyssandra_tpu.parallel.model_sharded import (
    omp_model_sharded as j_omp_model_sharded,
)
from lyssandra_tpu.solvers import batch_omp as j_batch_omp
from lyssandra_tpu.solvers import omp as j_omp
from lyssandra_tpu.solvers.encoder import SparseEncoder as JSparseEncoder
from lyssandra_tpu_torch.parallel import (
    Mesh,
    ShardedTensor,
    ksvd_train_step,
    make_mesh,
    omp_model_sharded,
    replicate,
    shard,
    shard_patches,
    sharded_ksvd_step,
)
from lyssandra_tpu_torch.parallel.mesh import map_data, row_copies
from lyssandra_tpu_torch.solvers.greedy import GreedyResult
from tests.conftest import make_problem

torch.set_num_threads(1)


def _mesh(data=-1, model=1):
    return make_mesh(data, model, devices=["cpu"] * 8)


def _np(a):
    return np.asarray(a.gather() if isinstance(a, ShardedTensor) else a)


@pytest.mark.parametrize("data,model", [(-1, 1), (4, 2)])
def test_mesh_shapes(data, model):
    mesh = _mesh(data, model)
    ref = j_make_mesh(data, model)
    assert mesh.devices.shape == ref.devices.shape
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_names == ref.axis_names
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_sharded_encode_equals_single_device(rng):
    # each slot codes its shard of X with its copy of D, as XLA runs
    # batch_omp per device on the sharded inputs
    D, X, _ = make_problem(rng, p=16, K=48, N=64, T=4, dtype=np.float32)
    ref = np.asarray(j_batch_omp(jnp.asarray(D), jnp.asarray(X), 4))
    mesh = _mesh()
    Xs, Ds = shard_patches(X, mesh), replicate(D, mesh)
    codes = np.empty(mesh.devices.shape, dtype=object)
    for ij in np.ndindex(*codes.shape):
        codes[ij] = lt.batch_omp(Ds.shards[ij], Xs.shards[ij], 4)
    out = ShardedTensor(mesh, (None, "data"), codes).gather().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(
        out, lt.batch_omp(D, X, 4, device="cpu").numpy(), atol=1e-6)


def test_encoder_with_mesh(rng):
    # the reference's slow case, against its unsharded call
    D, X, _ = make_problem(rng, p=16, K=48, N=160, T=4, dtype=np.float32)
    ref = np.asarray(JSparseEncoder("bomp", {"T": 4}, block=64).encode(X, D))
    single = lt.SparseEncoder("bomp", {"T": 4}, block=64,
                              device="cpu").encode(X, D)
    out = lt.SparseEncoder("bomp", {"T": 4}, block=64,
                           mesh=_mesh()).encode(X, D)
    assert out.device == torch.device("cpu")
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), single.numpy(), atol=1e-6)


@pytest.mark.parametrize("data,model,model_shard_atoms", [
    (-1, 1, False), (4, 2, True), (4, 2, False)],
    ids=["data8", "model_axis", "data4x2"])
def test_sharded_ksvd_step(rng, data, model, model_shard_atoms):
    D, X, _ = make_problem(rng, p=16, K=32, N=64, T=4, dtype=np.float32)
    mesh = _mesh(data, model)
    D2, G2 = sharded_ksvd_step(mesh, T=4,
                               model_shard_atoms=model_shard_atoms)(X, D)
    ref_D, ref_G = j_ksvd_train_step(jnp.asarray(X), jnp.asarray(D), T=4)
    np.testing.assert_allclose(_np(D2), np.asarray(ref_D), atol=1e-5)
    np.testing.assert_allclose(_np(G2), np.asarray(ref_G), atol=1e-4)
    # the outputs are placed as the reference's out_shardings
    assert D2.spec == ((None, "model") if model_shard_atoms else ())
    assert G2.spec == ("model" if model_shard_atoms else None, "data")
    assert D2.shape == D.shape and G2.shape == (32, 64)
    own_D, own_G = ksvd_train_step(torch.from_numpy(X), torch.from_numpy(D),
                                   T=4)
    np.testing.assert_allclose(_np(D2), own_D.numpy(), atol=1e-5)
    np.testing.assert_allclose(_np(G2), own_G.numpy(), atol=1e-4)


def test_sharded_ksvd_step_forwards_exact(rng):
    D, X, _ = make_problem(rng, p=16, K=32, N=64, T=4, dtype=np.float32)
    mesh = _mesh()
    D2, G2 = sharded_ksvd_step(mesh, T=4, exact=True, svd_iters=5)(X, D)
    ref_D, ref_G = j_ksvd_train_step(jnp.asarray(X), jnp.asarray(D), T=4,
                                     exact=True, svd_iters=5)
    np.testing.assert_allclose(_np(D2), np.asarray(ref_D), atol=1e-5)
    np.testing.assert_allclose(_np(G2), np.asarray(ref_G), atol=1e-4)
    # and the exact step genuinely differs from the approximate one
    apx_D, _ = ksvd_train_step(torch.from_numpy(X), torch.from_numpy(D), T=4)
    assert not np.allclose(_np(D2), apx_D.numpy(), atol=1e-6)


def test_sharded_ksvd_step_matches_the_reference_sharded_step(rng):
    # the reference's own sharded step on its 8 devices, same inputs
    D, X, _ = make_problem(rng, p=16, K=32, N=64, T=4, dtype=np.float32)
    D2, G2 = sharded_ksvd_step(_mesh(), T=4)(X, D)
    rD, rG = j_sharded_ksvd_step(j_make_mesh(), T=4)(jnp.asarray(X),
                                                     jnp.asarray(D))
    np.testing.assert_allclose(_np(D2), np.asarray(rD), atol=1e-5)
    np.testing.assert_allclose(_np(G2), np.asarray(rG), atol=1e-4)


def test_public_ksvd_learner_sharded_matches_single(rng):
    # the reference's slow case, against its unsharded fit, from one D0
    # (the two packages' seeded initial dictionaries differ)
    _, X, _ = make_problem(rng, p=16, K=24, N=64, T=3, dtype=np.float32)
    D0 = make_problem(rng, p=16, K=24, N=1, T=1, dtype=np.float32)[0]
    kw = dict(K=24, T=3, n_iter=3, replace_dead=False, seed=0)
    a = JKSVDLearner(JKSVDConfig(**kw)).fit(X, D0)
    single = lt.KSVDLearner(lt.KSVDConfig(**kw), device="cpu").fit(X, D0)
    b = lt.KSVDLearner(lt.KSVDConfig(**kw), mesh=_mesh()).fit(X, D0)
    np.testing.assert_allclose(b.D_.numpy(), np.asarray(a.D_), atol=2e-4)
    np.testing.assert_allclose(b.Gamma_.numpy(), np.asarray(a.Gamma_),
                               atol=2e-3)
    np.testing.assert_allclose(b.D_.numpy(), single.D_.numpy(), atol=1e-6)
    np.testing.assert_allclose(b.Gamma_.numpy(), single.Gamma_.numpy(),
                               atol=1e-5)


def test_omp_model_sharded_matches_replicated(rng):
    # huge-K path: atoms split over 'model', patches over 'data'
    D, X, _ = make_problem(rng, p=16, K=128, N=64, T=4, dtype=np.float32)
    G_sh = omp_model_sharded(D, X, 4, mesh=_mesh(2, 4)).numpy()
    G_ref = np.asarray(j_omp(jnp.asarray(D), jnp.asarray(X), 4))
    np.testing.assert_allclose(G_sh, G_ref, atol=1e-5)
    np.testing.assert_allclose(
        G_sh, np.asarray(j_omp_model_sharded(D, X, 4, mesh=j_make_mesh(2, 4))),
        atol=1e-5)
    np.testing.assert_allclose(
        G_sh, lt.omp(D, X, 4, device="cpu").numpy(), atol=1e-6)


def test_omp_model_sharded_eps_mode(rng):
    D, X, _ = make_problem(rng, p=16, K=128, N=64, T=3, dtype=np.float32)
    X[:, ::2] *= 0.05
    r_sh = omp_model_sharded(D, X, 6, eps=0.3, mesh=_mesh(2, 4),
                             dense=False)
    r_ref = j_omp(jnp.asarray(D), jnp.asarray(X), 6, eps=0.3, dense=False)
    r_jsh = j_omp_model_sharded(D, X, 6, eps=0.3, mesh=j_make_mesh(2, 4),
                                dense=False)
    r_own = lt.omp(D, X, 6, eps=0.3, dense=False, device="cpu")
    for want in (r_ref, r_jsh, r_own):
        np.testing.assert_array_equal(r_sh.nsel.numpy(),
                                      np.asarray(want.nsel))
        np.testing.assert_allclose(r_sh.gamma.numpy(),
                                   np.asarray(want.gamma), atol=1e-5)
    assert len(set(r_sh.nsel.tolist())) > 1      # lanes stop at various T


def test_omp_model_sharded_ties_and_uneven_atoms(rng):
    # an atom repeated across two slots' blocks is picked at its lower
    # index, as the replicated solver picks it; K=100 splits unevenly
    D, X, _ = make_problem(rng, p=16, K=100, N=40, T=3, dtype=np.float32)
    D[:, 70] = D[:, 10]
    X[:, :8] = D[:, [10] * 8] * 2.0
    res = omp_model_sharded(D, X, 3, mesh=_mesh(2, 4), dense=False)
    want = lt.omp(D, X, 3, dense=False, device="cpu")
    assert (res.idx[:8, 0] == 10).all()
    np.testing.assert_array_equal(res.idx.numpy(), want.idx.numpy())
    np.testing.assert_allclose(res.gamma.numpy(), want.gamma.numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError, match="cannot split"):
        omp_model_sharded(D[:, :3], X, 1, mesh=_mesh(2, 4))


def test_encoder_compact_with_mesh(rng):
    # test_api_surface.py's compact-codes case: GreedyResult pieces split
    # lane-major and gathered in slot order
    D, X, _ = make_problem(rng, p=16, K=32, N=48, T=3, dtype=np.float32)
    res = lt.SparseEncoder("bomp", {"T": 3}, check_atoms=False,
                           mesh=_mesh()).encode(X, D, dense=False)
    ref = JSparseEncoder("bomp", {"T": 3}, check_atoms=False).encode(
        X, D, dense=False)
    np.testing.assert_allclose(res.dense(32).numpy(),
                               np.asarray(ref.dense(32)), atol=2e-5)
    assert tuple(res.idx.shape) == (48, 3) and res.nsel.shape == (48,)


@pytest.mark.parametrize("alg,params", [
    ("omp", {"T": 3}), ("group_omp", {"T": 2, "groups": np.arange(32) // 4}),
    ("nn_omp", {"T": 3}), ("thresholding", {"lam": 0.3}),
    ("llc", {"knn": 4}), ("fista", {"lam": 0.2}), ("lasso", {"lam": 0.2})],
    ids=lambda v: v if isinstance(v, str) else "")
def test_encoder_routes_with_mesh(rng, alg, params):
    # every route with a mesh gives the unsharded port's codes on 61
    # signals in blocks of 25: uneven shards over 8 slots, a padded block
    D, X, _ = make_problem(rng, p=16, K=32, N=61, T=3, dtype=np.float32)
    if alg == "nn_omp":
        X = np.abs(X)
    single = lt.SparseEncoder(alg, params, block=25,
                              device="cpu").encode(X, D)
    out = lt.SparseEncoder(alg, params, block=25, mesh=_mesh()).encode(X, D)
    np.testing.assert_allclose(out.numpy(), single.numpy(), atol=1e-6)


def test_uneven_and_tiny_shards(rng):
    D, X, _ = make_problem(rng, p=16, K=32, N=5, T=2, dtype=np.float32)
    mesh = _mesh()
    Xs = shard_patches(X, mesh)
    assert [s.shape[1] for s in Xs.shards[:, 0]] == [1] * 5 + [0] * 3
    np.testing.assert_array_equal(Xs.gather().numpy(), X)
    out = lt.SparseEncoder("bomp", {"T": 2}, mesh=mesh).encode(X, D)
    np.testing.assert_allclose(
        out.numpy(), lt.batch_omp(D, X, 2, device="cpu").numpy(), atol=1e-6)


def test_map_data_rows_in_order(rng):
    # one call per data row on its shard and its copy of D; tuple and
    # GreedyResult outputs come back whole, in row order, on the first slot
    D, X, _ = make_problem(rng, p=16, K=32, N=11, T=2, dtype=np.float32)
    D, X = torch.from_numpy(D), torch.from_numpy(X)
    mesh = _mesh(3)
    Ds = row_copies(D, mesh)
    assert len(Ds) == 3 and all(d is D for d in Ds)
    outs = map_data(lambda d, x: (x, x.sum(dim=0)), Ds, X, mesh)
    assert [x.shape[1] for x, _ in outs] == [4, 4, 3]
    torch.testing.assert_close(torch.cat([x for x, _ in outs], dim=1), X)
    torch.testing.assert_close(torch.cat([s for _, s in outs]), X.sum(dim=0))
    res = map_data(lambda d, x: lt.batch_omp(d, x, 2, dense=False), Ds, X,
                   mesh)
    whole = GreedyResult.concatenate(res)
    assert isinstance(res[0], GreedyResult)
    torch.testing.assert_close(whole.dense(32),
                               lt.batch_omp(D, X, 2), atol=1e-6, rtol=0)


@pytest.mark.parametrize("spec", [(), (None, "data"), ("data",),
                                  (None, "model"), ("model", "data"),
                                  ("data", "model")])
def test_sharded_tensor_round_trip(rng, spec):
    A = rng.standard_normal((10, 13))
    mesh = _mesh(4, 2)
    S = shard(A, mesh, spec)
    assert S.shape == A.shape and S.spec == spec
    got = S.gather()
    assert got.dtype == torch.float32 and got.device == mesh.first
    np.testing.assert_array_equal(got.numpy(), A.astype(np.float32))
    for (i, j), piece in np.ndenumerate(S.shards):
        rows = np.array_split(np.arange(10), 4)[i] if spec[:1] == ("data",) \
            else np.array_split(np.arange(10), 2)[j] \
            if spec[:1] == ("model",) else np.arange(10)
        assert piece.shape[0] == len(rows)
    # a tensor keeps its dtype, and slots on one device share a copy
    T64 = torch.from_numpy(A)
    R = replicate(T64, mesh)
    assert R.shards[0, 0].dtype == torch.float64
    assert all(s is R.shards[0, 0] for s in R.shards.flat)
    with pytest.raises(ValueError, match="spec"):
        shard(A, mesh, ("data", "data"))


def test_make_mesh_checks():
    # no GPU here: the default mesh raises in the words of the device rule
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh(model=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(data=4, model=4, devices=["cpu"] * 8)
    assert make_mesh(data=3, devices=["cpu"] * 8).devices.shape == (3, 1)
    with pytest.raises(ValueError):
        Mesh(["cpu", "cpu"])


def test_mesh_type_and_device_checks():
    D = lt.dct_dictionary(8, 64, device="cpu")
    mesh = _mesh()
    for make in (
            lambda m, **kw: lt.SparseEncoder("bomp", {"T": 2}, mesh=m, **kw),
            lambda m, **kw: lt.KSVDLearner(lt.KSVDConfig(K=64), mesh=m,
                                           **kw),
            lambda m, **kw: lt.OnlineDictionaryLearner(mesh=m, **kw),
            lambda m, **kw: lt.Denoiser(D, mesh=m, **kw)):
        with pytest.raises(TypeError, match="Mesh"):
            make(object())
        with pytest.raises(ValueError, match="conflicts with the mesh"):
            make(mesh, device="cuda")
        make(mesh, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        sharded_ksvd_step(object())
    with pytest.raises(TypeError, match="Mesh"):
        omp_model_sharded(D, D, 2, mesh=object())
    with pytest.raises(ValueError, match="conflicts with the mesh"):
        lt.denoise(np.zeros((16, 16)), D, 20.0, mesh=mesh, device="cuda:0")


def test_online_fit_sharded_matches_single(rng):
    # tests/test_dict_learning.py's case: minibatch lanes coded per data
    # slot, statistics summed from the slots' partials; all three learners
    # start from one D0 (the packages' seeded initial dictionaries differ)
    D0, X, _ = make_problem(rng, p=16, K=24, N=256, T=3)
    Xf = np.asarray(X, np.float32)
    D0 = D0.astype(np.float32)
    kw = dict(K=24, lam=0.15, batch_size=64, chunk_batches=2, seed=0)
    a = JOnline(JOnlineDLConfig(**kw))
    a.state = JOnlineDLState(jnp.asarray(D0), jnp.zeros((24, 24)),
                             jnp.zeros((16, 24)), jnp.zeros((), jnp.int32))
    a.fit(Xf, seed=0)
    single = lt.OnlineDictionaryLearner(lt.OnlineDLConfig(**kw),
                                        device="cpu")
    b = lt.OnlineDictionaryLearner(lt.OnlineDLConfig(**kw), mesh=_mesh())
    for learner in (single, b):
        learner.state = lt.OnlineDLState(
            torch.from_numpy(D0), torch.zeros((24, 24)), torch.zeros((16, 24)),
            torch.zeros((), dtype=torch.int32))
        learner.fit(Xf, seed=0)
    np.testing.assert_allclose(b.D_.numpy(), np.asarray(a.D_), atol=2e-3)
    np.testing.assert_allclose(b.D_.numpy(), single.D_.numpy(), atol=2e-3)
    assert b.D_.device == torch.device("cpu") and len(b.history_) == 2


def _toy(size=48):
    y, x = np.mgrid[:size, :size]
    return (128 + 60 * np.sin(x / 5.0) * np.cos(y / 7.0)
            + 40 * (x > size // 2)).astype(np.float64)


@pytest.mark.parametrize("colour", [False, True], ids=["grey", "colour"])
def test_denoiser_with_mesh(rng, colour):
    # the blocked error-stopped coder over the data slots against the
    # unsharded port (its two-phase route), the same codes per lane
    img = _toy()
    if colour:
        img = np.stack([img, img.T, 255 - img], axis=-1)
    noisy = (img + 20.0 * rng.standard_normal(img.shape)).astype(np.float32)
    D = (lt.ops.dictionaries.dct_dictionary_color(8, 64, device="cpu")
         if colour else lt.dct_dictionary(8, 64, device="cpu"))
    cfg = lt.DenoiseConfig(sigma=20.0, T_max=12, block=300)
    single = lt.Denoiser(D, cfg)(noisy)
    mesh = _mesh()
    got = lt.Denoiser(D, cfg, mesh=mesh)(noisy)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-3)
    np.testing.assert_array_equal(
        lt.denoise(noisy, D, 20.0, cfg=cfg, mesh=mesh).numpy(), got.numpy())


def test_denoise_adaptive_with_mesh(rng):
    img = _toy(64)
    noisy = (img + 25.0 * rng.standard_normal(img.shape)).astype(np.float32)
    kw = dict(cfg=lt.DenoiseConfig(sigma=25.0, T_max=8), K=64, n_iter=2,
              n_train=1000, return_dictionary=True)
    out, D = lt.apps.denoise_adaptive(noisy, 25.0, device="cpu", **kw)
    got, Dm = lt.apps.denoise_adaptive(noisy, 25.0, mesh=_mesh(), **kw)
    np.testing.assert_allclose(Dm.numpy(), D.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=1e-3)


@pytest.mark.parametrize("task", ["ksvd", "online_dl", "denoise", "encode"])
def test_run_experiment_with_mesh(task):
    from lyssandra_tpu_torch.experiments import run_experiment

    data = {"images": ["barbara"], "size": 48, "n_patches": 128,
            "patch": 8, "K": 64, "seed": 7}
    params = {"ksvd": {"K": 36, "T": 3, "n_iter": 2, "init": "dct"},
              "online_dl": {"K": 16, "lam": 200.0, "batch_size": 32,
                            "chunk_batches": 2, "code_blocks": 1,
                            "seed": 0},
              "denoise": {"sigma": 25.0, "T_max": 8, "block": 500},
              "encode": {"algorithm": "bomp", "T": 4}}[task]
    spec = {"task": task, "data": data, "params": params}
    want = run_experiment(dict(spec, params=dict(params)), device="cpu")
    # the online learner's coder is a host loop per slot: two slots there
    mesh = make_mesh(devices=["cpu"] * 2) if task == "online_dl" else _mesh()
    got = run_experiment(dict(spec, params=dict(params)), mesh=mesh)
    _same_result(got, want)


def _same_result(got, want):
    """Runner results equal within rtol 1e-5, times aside."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in ("seconds", "patches_per_sec"):
            continue
        if isinstance(v, dict):
            _same_result(got[k], v)
        elif isinstance(v, str):
            assert got[k] == v
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5)


def test_mesh_config_matches_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(lt.MeshConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JMeshConfig)]
    assert ours == ref
    cfg = lt.MeshConfig(data=4, model=2)
    mesh = make_mesh(cfg.data, cfg.model, devices=["cpu"] * 8)
    assert mesh.shape == dict(j_make_mesh(cfg.data, cfg.model).shape)
    assert jax.device_count() == 8
