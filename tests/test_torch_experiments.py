"""The port's experiment runner and utilities against lyssandra_tpu on the
CPU: each spec runs through both packages' ``run_experiment``.

Tolerances: the encoders' and denoisers' metrics within rtol 1e-5 (the
same codes in float32); inpainting PSNR within 1e-3 dB; SRC accuracy
equal; K-SVD from the DCT start (init draws of the two packages cannot
match) as tests/test_torch_ksvd.py holds a fit: iteration 0's objective
within rtol 1e-4, later ones within 2%.  The runner's LARS codes
pixel-scale patches at lam=50 (about 11 atoms a patch), a well-posed
lasso; tests/test_torch_lars.py holds LARS near lam=0 by objective."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from lyssandra_tpu.experiments import run_experiment as j_run
from lyssandra_tpu.utils import load_image_folders as j_load_folders
from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.config import from_yaml
from lyssandra_tpu_torch.experiments import main, run_experiment
from lyssandra_tpu_torch.parallel import make_mesh
from lyssandra_tpu_torch.utils import (
    Workspace,
    cache_enabled,
    enable_compile_cache,
    load_image_folders,
    profile_trace,
    synthetic_image,
    timed,
)

torch.set_num_threads(1)

SPECS = {
    "ksvd": {"task": "ksvd",
             "data": {"images": ["barbara"], "size": 64, "n_patches": 512,
                      "patch": 8},
             "params": {"K": 64, "T": 3, "n_iter": 2, "init": "dct"}},
    "encode": {"task": "encode",
               "data": {"images": ["lena"], "size": 64, "n_patches": 256,
                        "patch": 8, "K": 64},
               "params": {"algorithm": "bomp", "T": 4}},
    "encode_lars": {"task": "encode",
                    "data": {"images": ["lena"], "size": 48,
                             "n_patches": 96, "patch": 8, "K": 64},
                    "params": {"algorithm": "lars", "lam": 50.0}},
    "denoise": {"task": "denoise",
                "data": {"images": ["barbara"], "size": 64, "K": 64,
                         "seed": 7},
                "params": {"sigma": 25.0, "T_max": 8, "block": 4096}},
    "denoise_color": {"task": "denoise",
                      "data": {"images": ["barbara"], "size": 48, "K": 64,
                               "seed": 7, "color": True},
                      "params": {"sigma": 25.0, "T_max": 8,
                                 "block": 4096}},
    "inpaint": {"task": "inpaint",
                "data": {"images": ["lena"], "size": 64, "K": 64, "seed": 1},
                "params": {"missing_frac": 0.25, "T": 6}},
    "src": {"task": "src", "data": {"dataset": "digits", "test_size": 0.5},
            "params": {"T": 5}},
}


def _write(tmp_path, spec, fmt):
    path = tmp_path / f"spec.{fmt}"
    if fmt == "yaml":
        import yaml

        path.write_text(yaml.safe_dump(spec))
    else:
        path.write_text(json.dumps(spec))
    return str(path)


@pytest.mark.parametrize("name,fmt", [
    ("ksvd", "yaml"), ("encode", "json"), ("encode_lars", "yaml"),
    ("denoise", "json"), ("denoise_color", "yaml"), ("inpaint", "json"),
    ("src", "yaml")])
def test_run_experiment_matches_jax(tmp_path, name, fmt):
    spec = SPECS[name]
    got = run_experiment(_write(tmp_path, spec, fmt), device="cpu")
    want = j_run(json.loads(json.dumps(spec)))
    assert sorted(got) == sorted(want)
    json.dumps(got)                      # plain JSON
    for k, v in want.items():
        if k in ("task", "image", "algorithm", "n", "n_train", "n_test",
                 "missing_frac", "accuracy"):
            assert got[k] == v, k
        elif k == "objective_trace":
            assert len(got[k]) == len(v)
            np.testing.assert_allclose(got[k][0], v[0], rtol=1e-4)
            np.testing.assert_allclose(got[k], v, rtol=0.02)
        elif k == "final_rmse":
            np.testing.assert_allclose(got[k], v, rtol=0.02)
        elif k.startswith("psnr") and name == "inpaint":
            np.testing.assert_allclose(got[k], v, atol=1e-3)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def test_encode_experiment_equals_direct_call():
    import lyssandra_tpu_torch as lt
    from lyssandra_tpu_torch.utils import (
        patch_dataset,
        standard_test_image,
    )

    got = run_experiment(SPECS["encode_lars"], device="cpu")
    X = torch.from_numpy(patch_dataset(
        [standard_test_image("lena", 48)], p=8, n_patches=96,
        seed=0).astype(np.float32))
    D = lt.dct_dictionary(8, 64, device="cpu")
    G = lt.SparseEncoder("lars", {"lam": 50.0},
                         check_atoms=False).encode(X, D)
    assert got["rel_err"] == float(torch.linalg.norm(X - D @ G)
                                   / torch.linalg.norm(X))


def test_workspace_artifacts_read_back(tmp_path):
    spec = dict(SPECS["ksvd"], workspace=str(tmp_path / "ws"))
    got = run_experiment(spec, device="cpu")
    ws = Workspace(str(tmp_path / "ws"))
    assert ws.load_json("result") == json.loads(json.dumps(got))
    D = ws.load_array("D")
    D = D["D"] if isinstance(D, dict) else D
    assert D.shape == (64, 64)
    np.testing.assert_allclose(np.linalg.norm(D, axis=0), 1.0, atol=1e-4)
    spec = dict(SPECS["encode"], workspace=str(tmp_path / "ws2"))
    run_experiment(spec, device="cpu")
    with np.load(tmp_path / "ws2" / "Gamma.npz") as z:
        G = z["Gamma"]
    assert G.shape == (64, 256)
    assert ((np.abs(G) > 1e-10).sum(axis=0) <= 4).all()


def test_online_and_lcksvd_experiments_run(tmp_path):
    # their init draws differ from the reference's; the result's layout and
    # the learning are held here
    got = run_experiment({
        "task": "online_dl",
        "data": {"images": ["barbara"], "size": 48, "n_patches": 232,
                 "patch": 8, "n_holdout": 40},
        "params": {"K": 16, "lam": 200.0, "batch_size": 32,
                   "chunk_batches": 2}},
        device="cpu")
    trace = got["holdout_objective_trace"]
    assert len(trace) == 3 and trace[-1] < trace[0]
    rng = np.random.default_rng(0)
    X = rng.standard_normal((16, 90)).astype(np.float32)
    y = np.repeat(np.arange(3), 30)
    X[:3] += 3.0 * np.eye(3, dtype=np.float32)[:, y]
    np.savez(tmp_path / "d.npz", X=X, y=y)
    got = run_experiment({
        "task": "lc_ksvd", "data": {"npz": str(tmp_path / "d.npz")},
        "params": {"K": 12, "T": 3, "n_iter": 2}}, device="cpu")
    assert got["n_train"] == 63 and got["n_test"] == 27
    assert got["accuracy"] > 0.5


def test_mesh_and_errors(tmp_path):
    with pytest.raises(TypeError, match="Mesh"):
        run_experiment(SPECS["encode"], mesh=object(), device="cpu")
    mesh = make_mesh(devices=["cpu"] * 2)
    assert run_experiment(SPECS["encode"], mesh=mesh) == run_experiment(
        SPECS["encode"], device="cpu")
    with pytest.raises(ValueError, match="unknown task"):
        run_experiment({"task": "nope"}, device="cpu")
    with pytest.raises(ValueError, match="labeled task"):
        run_experiment({"task": "src", "data": {}}, device="cpu")


def test_main_and_json_fallback(tmp_path, monkeypatch, capsys):
    # main runs each spec on the default device, the GPU: here the CPU
    # stands in for it
    path = _write(tmp_path, SPECS["encode"], "json")
    import lyssandra_tpu_torch.experiments as ex

    real = ex.run_experiment
    monkeypatch.setattr(ex, "run_experiment",
                        lambda spec: real(spec, device="cpu"))
    assert main([path]) == 0
    assert "'avg_nnz'" in capsys.readouterr().out
    assert main([]) == 1
    # without PyYAML the spec is read as JSON
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert from_yaml(path)["task"] == "encode"


def test_load_image_folders_npy(tmp_path):
    for cls, kind in (("a_smooth", "smooth"), ("b_tex", "texture")):
        d = tmp_path / cls
        d.mkdir()
        for i in range(3):
            np.save(d / f"im{i}.npy", synthetic_image(kind, 24, seed=i))
        (d / "notes.txt").write_text("not an image")
    imgs, y, names = load_image_folders(str(tmp_path))
    jimgs, jy, jnames = j_load_folders(str(tmp_path))
    assert names == jnames == ["a_smooth", "b_tex"]
    np.testing.assert_array_equal(y, jy)
    assert y.dtype == np.int32 and list(y) == [0, 0, 0, 1, 1, 1]
    for a, b in zip(imgs, jimgs):
        np.testing.assert_array_equal(a, b)
    np.save(tmp_path / "a_smooth" / "big.npy", np.zeros((30, 30)))
    with pytest.raises(ValueError, match="mismatched"):
        load_image_folders(str(tmp_path))
    assert len(load_image_folders(str(tmp_path), allow_mixed=True)[0]) == 7
    with pytest.raises(ValueError, match="no class"):
        load_image_folders(str(tmp_path / "a_smooth"))


def test_profile_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with profile_trace(None):
        pass
    assert os.listdir(logdir) == ["trace.json"]


def test_timed():
    calls = []

    def f(x, scale=1.0):
        calls.append(1)
        return {"y": (torch.sin(x) * scale).sum(), "n": 3}

    out, dt = timed(f, torch.ones(32, 32), scale=2.0, warmup=2, reps=3)
    assert dt > 0 and len(calls) == 5
    assert torch.isclose(out["y"], 2048.0 * torch.sin(torch.tensor(1.0)))


def test_enable_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.DEFAULT_DIR)
    assert not cache_enabled()
    path = enable_compile_cache(str(tmp_path / "kernels"))
    assert os.path.isdir(path) and cache_enabled()
    assert _build.library_path().parent == tmp_path / "kernels"
    assert enable_compile_cache() == str(_build.DEFAULT_DIR.resolve())
    assert not cache_enabled()
