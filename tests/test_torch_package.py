"""Package-level contracts of the port: it never imports JAX, its copied
pieces match the reference's, and no kernel launches on the CPU."""

import dataclasses
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu.config import DenoiseConfig as JDenoiseConfig
from lyssandra_tpu.config import KSVDConfig as JKSVDConfig
from lyssandra_tpu.config import LassoConfig as JLassoConfig
from lyssandra_tpu.config import LCKSVDConfig as JLCKSVDConfig
from lyssandra_tpu.config import OMPConfig as JOMPConfig
from lyssandra_tpu.config import OnlineDLConfig as JOnlineDLConfig
from lyssandra_tpu.config import WhitenConfig as JWhitenConfig
from lyssandra_tpu.config import from_yaml as j_from_yaml
from lyssandra_tpu.utils.datasets import standard_test_image as j_standard
from lyssandra_tpu.utils.datasets import synthetic_image as j_synthetic
from lyssandra_tpu_torch.utils.datasets import (
    load_image,
    standard_test_image,
    synthetic_image,
)
from lyssandra_tpu_torch.utils.interop import (
    denoiser_from_reference,
    dictionary_from_numpy,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lyssandra_tpu_torch")


def test_import_leaves_jax_out():
    code = ("import sys, lyssandra_tpu_torch, lyssandra_tpu_torch.utils."
            "interop, lyssandra_tpu_torch.utils.datasets, "
            "lyssandra_tpu_torch.solvers.lasso, lyssandra_tpu_torch.ops."
            "cuda_fs, lyssandra_tpu_torch.dict_learning.ksvd, "
            "lyssandra_tpu_torch.utils.workspace, "
            "lyssandra_tpu_torch.dict_learning.online, "
            "lyssandra_tpu_torch.classify.lc_ksvd, "
            "lyssandra_tpu_torch.classify.src, "
            "lyssandra_tpu_torch.apps.denoise, "
            "lyssandra_tpu_torch.apps.features, "
            "lyssandra_tpu_torch.ops.whitening, "
            "lyssandra_tpu_torch.experiments, "
            "lyssandra_tpu_torch.utils.profiling, "
            "lyssandra_tpu_torch.parallel, "
            "lyssandra_tpu_torch.utils.compile_cache; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lyssandra_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_import_jax_or_the_reference():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|lyssandra_tpu)\b", re.M)
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not pattern.search(f.read()), name


def test_numerics_policy_is_full_fp32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_denoise_config_matches_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(lt.DenoiseConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JDenoiseConfig)]
    assert ours == ref


def test_ksvd_config_matches_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(lt.KSVDConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JKSVDConfig)]
    assert ours == ref


@pytest.mark.parametrize("name", ["OnlineDLConfig", "LCKSVDConfig"])
def test_learning_configs_match_reference(name):
    ref = {"OnlineDLConfig": JOnlineDLConfig,
           "LCKSVDConfig": JLCKSVDConfig}[name]
    ours = [(f.name, f.default) for f in dataclasses.fields(getattr(lt, name))]
    assert ours == [(f.name, f.default) for f in dataclasses.fields(ref)]


@pytest.mark.parametrize("name", ["OMPConfig", "LassoConfig",
                                  "WhitenConfig"])
def test_solver_and_whiten_configs_match_reference(name):
    ref = {"OMPConfig": JOMPConfig, "LassoConfig": JLassoConfig,
           "WhitenConfig": JWhitenConfig}[name]
    ours = [(f.name, f.default) for f in dataclasses.fields(getattr(lt, name))]
    assert ours == [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert dataclasses.fields(getattr(lt, name))[0].type == \
        dataclasses.fields(ref)[0].type


def test_config_helpers_match_reference(tmp_path):
    path = tmp_path / "spec.yaml"
    path.write_text("task: ksvd\nparams: {K: 64, T: 3}\n")
    assert lt.config.from_yaml(str(path)) == j_from_yaml(str(path))
    cfg = lt.config.replace(lt.KSVDConfig(), K=64)
    assert cfg.K == 64 and cfg.T == lt.KSVDConfig().T
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.K = 1


# names and modules of the reference that the port does not have yet, each
# with the ROADMAP item that ports it: none are left
NOT_PORTED: dict[str, str] = {}

# the subpackages and modules whose public names the port mirrors
SUBPACKAGES = ["config", "ops", "ops.whitening", "solvers", "apps", "utils",
               "dict_learning", "classify", "experiments", "parallel"]


def test_top_level_names_match_reference():
    import inspect

    import lyssandra_tpu

    ref = {n for n in dir(lyssandra_tpu) if not n.startswith("_")
           and not inspect.ismodule(getattr(lyssandra_tpu, n))}
    missing = sorted(n for n in ref if not hasattr(lt, n)
                     and n not in NOT_PORTED)
    assert not missing, f"not in the port and not listed: {missing}"
    stale = sorted(n for n in NOT_PORTED if hasattr(lt, n))
    assert not stale, f"listed as not ported but present: {stale}"
    assert "MeshConfig" in ref
    for name in ("contrast_normalize", "normalize_atoms",
                 "reconstruct_from_patches", "KSVDConfig", "KSVDLearner",
                 "ksvd", "init_dictionary", "Workspace", "OnlineDLConfig",
                 "OnlineDictionaryLearner", "online_dl_step",
                 "feature_sign_scan", "LCKSVD", "LCKSVDConfig",
                 "SRCClassifier", "LinearSVM", "LinearClassifier", "lars",
                 "lars_path", "LarsPath", "lasso_lars", "Whitener",
                 "ZCAWhitener", "FeatureExtractor", "OMPConfig",
                 "LassoConfig", "WhitenConfig", "enable_compile_cache"):
        assert name in lt.__all__
    # the reference's last subpackage, the device mesh, is ported
    import importlib.util

    assert importlib.util.find_spec("lyssandra_tpu.parallel") is not None
    assert importlib.util.find_spec("lyssandra_tpu_torch.parallel") is not None
    assert "MeshConfig" in lt.__all__


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_names_match_reference(sub):
    # every public name of the reference's subpackage (modules aside) is in
    # the port's, apart from the A8 names
    import importlib
    import inspect

    ref = importlib.import_module(f"lyssandra_tpu.{sub}")
    ours = importlib.import_module(f"lyssandra_tpu_torch.{sub}")
    names = {n for n in dir(ref) if not n.startswith("_")
             and not inspect.ismodule(getattr(ref, n))}
    missing = sorted(n for n in names if not hasattr(ours, n)
                     and n not in NOT_PORTED)
    assert not missing, f"lyssandra_tpu_torch.{sub} lacks {missing}"
    assert not [n for n in NOT_PORTED if hasattr(ours, n)]
    for n in getattr(ref, "__all__", []):
        assert n in getattr(ours, "__all__", dir(ours)), n


@pytest.mark.parametrize("kind", ["smooth", "texture", "edges", "mix"])
def test_synthetic_image_matches_reference(kind):
    np.testing.assert_array_equal(synthetic_image(kind, 48, seed=7),
                                  j_synthetic(kind, 48, seed=7))


@pytest.mark.parametrize("name", ["barbara", "lena", "boat"])
@pytest.mark.parametrize("color", [False, True], ids=["grey", "colour"])
def test_standard_test_image_matches_reference(name, color, monkeypatch):
    monkeypatch.delenv("LYSSA_DATA_DIR", raising=False)
    got = standard_test_image(name, 40, color=color)
    assert got.shape == ((40, 40, 3) if color else (40, 40))
    np.testing.assert_array_equal(got, j_standard(name, 40, color=color))


def test_standard_test_image_reads_the_data_dir(tmp_path, monkeypatch):
    img = np.arange(36, dtype=np.float64).reshape(6, 6)
    np.save(tmp_path / "barbara.npy", img)
    monkeypatch.setenv("LYSSA_DATA_DIR", str(tmp_path))
    np.testing.assert_array_equal(standard_test_image("barbara"), img)
    np.testing.assert_array_equal(standard_test_image("barbara"),
                                  j_standard("barbara"))
    np.savez(tmp_path / "z.npz", first=img)
    np.testing.assert_array_equal(load_image(str(tmp_path / "z.npz")), img)


def test_launch_counters_stay_zero_on_cpu(rng):
    lt.reset_launch_counts()
    img = 255.0 * rng.random((24, 24))
    noisy = img + 20.0 * rng.standard_normal(img.shape)
    lt.denoise(noisy, lt.dct_dictionary(8, 64, device="cpu"), 20.0,
               cfg=lt.DenoiseConfig(sigma=20.0, T_max=12))
    D = lt.dct_dictionary(4, 36, device="cpu")
    lt.batch_omp(D, torch.randn(16, 40), 3)
    lt.group_omp(D, torch.randn(16, 40), np.repeat(np.arange(9), 4), 2)
    lt.SparseEncoder("lasso", {"lam": 0.2, "cold_unroll": 3,
                               "cold_backend": "pallas"}).encode(
        torch.randn(16, 40), D)
    lt.solvers.greedy._omp_impl(D, torch.randn(16, 40), 0.0, T=3,
                                eps_mode=False, fused_select=True)
    lt.SparseEncoder("lars", {"lam": 0.2}).encode(torch.randn(16, 40), D)
    lt.FeatureExtractor(lt.dct_dictionary(4, 16, device="cpu"), patch=4,
                        stride=2).transform(torch.randn(2, 12, 12))
    assert lt.launch_counts() == {
        "omp_fused_t": 0, "omp_fused_eps": 0, "omp_residual_t": 0,
        "omp_residual_eps": 0, "omp_residual_select": 0,
        "omp_residual_update": 0, "fused_patches": 0, "group_omp_fused": 0,
        "fs_cold": 0, "fs_scan": 0, "fs_scan_seeded": 0,
        "select_abs_argmax": 0, "gram": 0, "online_sweep": 0,
        "ksvd_sweep": 0}


# the counters portbench sums and chip_smoke.py reads by name
LAUNCH_KEYS = {
    "omp_fused_t", "omp_fused_eps", "omp_residual_t", "omp_residual_eps",
    "omp_residual_select", "omp_residual_update", "fused_patches",
    "group_omp_fused", "fs_cold", "fs_scan", "fs_scan_seeded",
    "select_abs_argmax", "gram", "online_sweep", "ksvd_sweep"}


@pytest.mark.parametrize("case", ["plain-versions", "reset", "keys"])
def test_launch_registry(rng, case):
    from lyssandra_tpu_torch.ops import _launch

    lt.reset_launch_counts()
    if case == "plain-versions":
        # every wrapper on CPU tensors runs its plain version, uncounted
        D = torch.randn(16, 40)
        X = torch.randn(16, 8)
        lt.ops.omp_fused(D, X, T=3)
        lt.ops.omp_residual_fused(D, X, T=3, eps=0.1, eps_mode=True)
        lt.ops.select_abs_argmax(X.T, D)
        lt.ops.gram(D, X)
        lt.ops.group_omp_fused(D, X, np.repeat(np.arange(10), 4), 2)
        lt.ops.fs_cold_fused(D, X, lam=0.2, t_unroll=3)
        lt.ops.fs_scan_fused(D, X, lam=0.2, max_iter=4)
        lt.ops.fs_scan_seeded(
            D, X, lt.ops.fs_cold_fused(D, X, lam=0.2, t_unroll=3), lam=0.2,
            max_iter=4)
        lt.ops.fused_patch_pipeline_p1(torch.randn(12, 12), 4)
        lt.ops.online_sweep_fused(D, torch.eye(40), torch.randn(16, 40), 1)
        lt.ops.ksvd_sweep_fused(X, D[:, :6], torch.randn(6, 8), 1)
        assert set(lt.launch_counts().values()) == {0}
    elif case == "reset":
        for key in LAUNCH_KEYS:
            _launch.count(key)
        assert set(lt.launch_counts().values()) == {1}
        lt.reset_launch_counts()
        assert set(lt.launch_counts().values()) == {0}
    else:
        counts = lt.launch_counts()
        assert set(counts) == LAUNCH_KEYS
        counts["gram"] = 5          # a copy: the registry keeps its count
        assert lt.launch_counts()["gram"] == 0


def test_dictionary_from_numpy_checks(rng):
    D = rng.standard_normal((16, 20))
    D /= np.linalg.norm(D, axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = dictionary_from_numpy(D, device="cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_allclose(t.numpy(), D, atol=1e-7)
    assert dictionary_from_numpy(D.T.copy().T, "cpu").is_contiguous()
    with pytest.warns(UserWarning, match="unit-norm"):
        dictionary_from_numpy(2.0 * D, "cpu")
    with pytest.raises(ValueError):
        dictionary_from_numpy(D[0], "cpu")
    with pytest.raises(TypeError):
        dictionary_from_numpy(np.ones((4, 4), np.int32), "cpu")
    bad = D.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError):
        dictionary_from_numpy(bad, "cpu")


def test_denoiser_from_reference_takes_reference_config():
    cfg = JDenoiseConfig(sigma=15.0, T_max=12, order="energy")
    den = denoiser_from_reference(
        np.asarray(lt.dct_dictionary(8, 64, device="cpu")),
        dataclasses.asdict(cfg), device="cpu")
    assert dataclasses.asdict(den.cfg) == dataclasses.asdict(cfg)
    with pytest.raises(TypeError):
        denoiser_from_reference(np.eye(64), {"not_a_field": 1}, "cpu")


# reference parameters the port does not take, by callable, each with its
# reason: none are expected
SIGNATURE_EXCEPTIONS: dict[str, tuple[str, ...]] = {}


def _reference_callables():
    """(case id, reference callable, port callable) for every public
    callable of the reference's top level and SUBPACKAGES, and every public
    method (and ``__init__``) of its classes."""
    import importlib
    import inspect

    cases = []
    for sub in [""] + SUBPACKAGES:
        ref = importlib.import_module(
            "lyssandra_tpu" + ("." + sub if sub else ""))
        ours = importlib.import_module(
            "lyssandra_tpu_torch" + ("." + sub if sub else ""))
        for name in dir(ref):
            r = getattr(ref, name)
            if (name.startswith("_") or inspect.ismodule(r)
                    or not callable(r)):
                continue
            o = getattr(ours, name, None)
            cases.append((f"{sub or 'top'}:{name}", r, o))
            if inspect.isclass(r):
                for m in vars(r):
                    if m.startswith("_") and m != "__init__":
                        continue
                    if not callable(getattr(r, m)):
                        continue
                    cases.append((f"{sub or 'top'}:{name}.{m}",
                                   getattr(r, m), getattr(o, m, None)))
    return cases


_CALLABLES = _reference_callables()


@pytest.mark.parametrize("case, ref, ours", _CALLABLES,
                         ids=[c[0] for c in _CALLABLES])
def test_port_accepts_every_reference_keyword(case, ref, ours):
    import inspect

    assert ours is not None, f"{case} is not in the port"
    rp = inspect.signature(ref).parameters
    op = inspect.signature(ours).parameters
    var_kw = any(v.kind is v.VAR_KEYWORD for v in op.values())
    missing = tuple(
        n for n, v in rp.items()
        if n not in op and not (var_kw and v.kind is not v.VAR_POSITIONAL))
    assert missing == SIGNATURE_EXCEPTIONS.get(case, ()), (
        f"{case}: the port refuses the reference's {missing}")


@pytest.mark.parametrize("fn", ["dct_dictionary", "dct_dictionary_color",
                                "init_dictionary"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_dictionary_dtype_matches_reference(fn, dtype):
    import jax.numpy as jnp

    import lyssandra_tpu.ops.dictionaries as jdict

    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    if fn == "init_dictionary":
        X = np.zeros((3 * 8 * 8, 5))
        got = lt.init_dictionary(torch.as_tensor(X), 64, "dct", dtype=dtype)
        want = jdict.init_dictionary(X, 64, "dct", dtype=jnp.float32)
    else:
        got = getattr(lt.ops, fn)(8, 64, dtype=dtype, device="cpu")
        want = getattr(jdict, fn)(8, 64, dtype=jdtype)
    assert got.dtype == dtype and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["random", "data"])
def test_init_dictionary_dtype(method, rng):
    X = torch.as_tensor(rng.standard_normal((16, 40)), dtype=torch.float32)
    D32 = lt.init_dictionary(X, 24, method, seed=2)
    D64 = lt.init_dictionary(X, 24, method, seed=2, dtype=torch.float64)
    assert D32.dtype == torch.float32 and D64.dtype == torch.float64
    np.testing.assert_allclose(D64.numpy(), D32.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.vector_norm(D64, dim=0).numpy(),
                               1.0, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fn", ["batch_omp", "omp", "nn_omp", "masked_omp"])
def test_precision_keyword_is_ignored(fn, rng):
    import jax

    D = rng.standard_normal((16, 40))
    D /= np.linalg.norm(D, axis=0)
    X = rng.standard_normal((16, 30))
    args = (torch.as_tensor(D, dtype=torch.float32),
            torch.as_tensor(X, dtype=torch.float32))
    if fn == "masked_omp":
        args += (torch.as_tensor(rng.random((16, 30)) > 0.3,
                                 dtype=torch.float32),)
    call = getattr(lt.solvers, fn)
    want = call(*args, 4, dense=False)
    for precision in ("highest", jax.lax.Precision.HIGHEST, None):
        got = call(*args, 4, precision=precision, dense=False)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
