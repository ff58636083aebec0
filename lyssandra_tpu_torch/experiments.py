"""Spec-driven experiment runner (``lyssandra_tpu.experiments``
counterpart): an experiment is a YAML or JSON file of a task, its data and
its parameters; it runs end to end and its artifacts land in a workspace
directory.

    python -m lyssandra_tpu_torch.experiments exp.yaml [exp2.json ...]

Experiment spec (YAML, or JSON where PyYAML is not installed):

    task: ksvd | online_dl | denoise | inpaint | lc_ksvd | src | encode
    workspace: runs/exp1          # optional; artifacts + result land here
    data:                         # one of:
      images: [barbara, lena]     #   standard test images (procedural
      size: 512                   #   stand-ins unless LYSSA_DATA_DIR
      n_patches: 50000            #   holds the files)
      patch: 8
      # dataset: digits           #   sklearn's bundled digits (X, y)
      # npz: path/to/data.npz     #   arrays X (p, N) [, y (N,)]
      # folders: path/to/root     #   class-per-subdirectory image dataset
      # resize: 32                #   optional square resize with folders
      # color: true               #   RGB images -> (3 p^2, N) patches
    params: {K: 512, T: 8, n_iter: 20, ...}   # config fields for the task

Every task returns (and saves) a plain-JSON result dict; learned arrays
(dictionaries, codes, images) are saved as .npz in the workspace.  The
``lc_ksvd`` and ``src`` tasks split the data with scikit-learn, imported
only there.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.config import (
    DenoiseConfig,
    KSVDConfig,
    LCKSVDConfig,
    OnlineDLConfig,
    from_yaml,
)
from lyssandra_tpu_torch.parallel.mesh import mesh_device
from lyssandra_tpu_torch.utils.workspace import Workspace


def _load_patches(data: dict[str, Any]) -> np.ndarray:
    from lyssandra_tpu_torch.utils import (
        load_image,
        patch_dataset,
        standard_test_image,
    )

    p = int(data.get("patch", 8))
    n = int(data.get("n_patches", 50000))
    size = int(data.get("size", 512))
    color = bool(data.get("color", False))   # RGB -> (3 p^2, N) patches
    if "npz" in data:
        with np.load(data["npz"]) as z:
            return np.asarray(z["X"], np.float32)
    if "folders" in data:
        from lyssandra_tpu_torch.utils import load_image_folders

        imgs, _, _ = load_image_folders(
            data["folders"], size=data.get("resize"), allow_mixed=True,
            gray=not color)
    elif "paths" in data:
        imgs = [load_image(path, gray=not color) for path in data["paths"]]
    else:
        imgs = [standard_test_image(name, size, color=color)
                for name in data.get("images", ["barbara", "lena"])]
    return patch_dataset(imgs, p=p, n_patches=n,
                         seed=int(data.get("seed", 0))).astype(np.float32)


def _load_labeled(data: dict[str, Any]):
    if data.get("dataset") == "digits":
        from sklearn.datasets import load_digits

        d = load_digits()
        X = d.data.T.astype(np.float32)
        X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-9)
        return X, d.target
    if "npz" in data:
        with np.load(data["npz"]) as z:
            return np.asarray(z["X"], np.float32), np.asarray(z["y"], int)
    if "folders" in data:
        # class-per-subdirectory images -> one unit vector per image
        from lyssandra_tpu_torch.utils import load_image_folders

        imgs, y, _ = load_image_folders(data["folders"],
                                        size=data.get("resize"))
        X = np.stack([im.reshape(-1) for im in imgs], axis=1)
        X = X.astype(np.float32)
        X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-9)
        return X, y
    raise ValueError(
        "labeled task needs data.dataset=digits, data.npz or data.folders")


def _split(X, y, test_size, seed):
    from sklearn.model_selection import train_test_split

    Xtr, Xte, ytr, yte = train_test_split(
        X.T, y, test_size=test_size, random_state=seed, stratify=y)
    return Xtr.T, Xte.T, ytr, yte


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def run_experiment(spec: dict[str, Any] | str, *, mesh=None,
                   device=None) -> dict:
    """Run one experiment spec (a dict, or the path of a YAML/JSON file)
    on ``device`` (default: the GPU).  ``mesh`` (``parallel.Mesh``) goes to
    the K-SVD and online learners, the denoiser and the encoder, as in the
    reference; the other tasks run on its first slot."""
    if mesh is not None:
        device = mesh_device(mesh, device)
    if isinstance(spec, str):
        spec = from_yaml(spec)
    task = spec["task"]
    data = dict(spec.get("data", {}))
    params = dict(spec.get("params", {}))
    ws = Workspace(spec["workspace"]) if "workspace" in spec else None
    device = resolve_device(device)

    if task == "ksvd":
        from lyssandra_tpu_torch.dict_learning import KSVDLearner

        X = _load_patches(data)
        learner = KSVDLearner(KSVDConfig(**params), mesh=mesh, workspace=ws,
                              device=device).fit(X)
        result = {
            "task": task,
            "final_rmse": learner.history_[-1]["rmse"],
            "objective_trace": [h["objective"] for h in learner.history_],
        }
        if ws:
            ws.save_array("D", D=_np(learner.D_))
    elif task == "online_dl":
        from lyssandra_tpu_torch.dict_learning import OnlineDictionaryLearner

        X = _load_patches(data)
        n_hold = int(data.get("n_holdout", 0))
        hold = X[:, :n_hold] if n_hold else None
        learner = OnlineDictionaryLearner(
            OnlineDLConfig(**params), mesh=mesh, device=device,
        ).fit(X[:, n_hold:], n_epochs=int(spec.get("n_epochs", 1)),
              holdout=hold)
        result = {"task": task, "history": learner.history_[-1]}
        if hold is not None:
            result["holdout_objective_trace"] = [
                h["holdout_objective"] for h in learner.history_]
        if ws:
            ws.save_array("D", D=_np(learner.D_))
    elif task == "denoise":
        from lyssandra_tpu_torch.apps import denoise, psnr
        from lyssandra_tpu_torch.ops import (
            dct_dictionary,
            dct_dictionary_color,
        )
        from lyssandra_tpu_torch.utils import standard_test_image

        size = int(data.get("size", 512))
        name = data.get("images", ["barbara"])[0]
        color = bool(data.get("color", False))
        img = standard_test_image(name, size, color=color)
        cfg = DenoiseConfig(**params)
        rng = np.random.default_rng(int(data.get("seed", 7)))
        noisy = img + cfg.sigma * rng.standard_normal(img.shape)
        K = int(data.get("K", 256))
        D = (dct_dictionary_color(cfg.patch, K, device=device) if color
             else dct_dictionary(cfg.patch, K, device=device))
        den = denoise(noisy.astype(np.float32), D, cfg.sigma, cfg=cfg,
                      mesh=mesh, device=device)
        result = {
            "task": task, "image": name,
            "psnr_noisy": psnr(noisy, img),
            "psnr": psnr(den, img),
        }
        if ws:
            ws.save_array("denoised", img=_np(den))
    elif task == "inpaint":
        from lyssandra_tpu_torch.apps import inpaint, psnr
        from lyssandra_tpu_torch.ops import dct_dictionary
        from lyssandra_tpu_torch.utils import standard_test_image

        size = int(data.get("size", 256))
        name = data.get("images", ["lena"])[0]
        img = standard_test_image(name, size)
        rng = np.random.default_rng(int(data.get("seed", 0)))
        frac = float(params.pop("missing_frac", 0.3))
        mask = (rng.uniform(size=img.shape) > frac).astype(np.float64)
        D = dct_dictionary(int(params.pop("patch", 8)),
                           int(data.get("K", 256)), device=device)
        out = _np(inpaint(img * mask, mask, D, device=device,
                          **params)).astype(np.float64)
        miss = mask == 0
        result = {
            "task": task, "image": name, "missing_frac": frac,
            "psnr_corrupted": psnr((img * mask)[miss], img[miss]),
            "psnr_inpainted": psnr(out[miss], img[miss]),
        }
        if ws:
            ws.save_array("inpainted", img=out)
    elif task in ("lc_ksvd", "src"):
        X, y = _load_labeled(data)
        Xtr, Xte, ytr, yte = _split(X, y, float(data.get("test_size", 0.3)),
                                    int(data.get("seed", 0)))
        if task == "lc_ksvd":
            from lyssandra_tpu_torch.classify import LCKSVD

            model = LCKSVD(LCKSVDConfig(**params), device=device)
        else:
            from lyssandra_tpu_torch.classify import SRCClassifier

            model = SRCClassifier(**params, device=device)
        model.fit(Xtr, ytr)
        result = {"task": task, "accuracy": model.score(Xte, yte),
                  "n_train": Xtr.shape[1], "n_test": Xte.shape[1]}
    elif task == "encode":
        from lyssandra_tpu_torch.ops import dct_dictionary
        from lyssandra_tpu_torch.solvers import SparseEncoder

        X = torch.as_tensor(_load_patches(data), device=device)
        alg = params.pop("algorithm", "bomp")
        enc = SparseEncoder(alg, params, mesh=mesh, check_atoms=False,
                            device=device)
        D = dct_dictionary(int(data.get("patch", 8)),
                           int(data.get("K", 256)), device=device)
        Gamma = enc.encode(X, D)
        R = X - D @ Gamma
        result = {
            "task": task, "algorithm": alg, "n": X.shape[1],
            "rel_err": float(torch.linalg.norm(R) / torch.linalg.norm(X)),
            "avg_nnz": float((Gamma.abs() > 1e-10).sum(dim=0).double()
                             .mean()),
        }
        if ws:
            ws.save_array("Gamma", Gamma=_np(Gamma))
    else:
        raise ValueError(f"unknown task: {task}")

    if ws:
        ws.save_json("result", result)
    return result


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    for path in argv:
        print(run_experiment(path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
