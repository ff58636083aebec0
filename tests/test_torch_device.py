"""Where the port's public entry points run: on the GPU unless the caller
asks for the CPU.  Numpy inputs with no device and no GPU raise, naming
``device='cpu'``; CPU tensors run on the CPU; with a GPU present, the
default is ``cuda``.  There is no silent CPU fallback."""

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.apps import denoise_adaptive, inpaint
from lyssandra_tpu_torch.classify import one_hot
from lyssandra_tpu_torch.classify.lc_ksvd import build_label_consistency
from lyssandra_tpu_torch.solvers import masked_omp
from lyssandra_tpu_torch.utils.interop import (
    denoiser_from_reference,
    dictionary_from_numpy,
    lcksvd_from_reference,
    online_state_from_reference,
    src_from_reference,
)

torch.set_num_threads(1)


LABELS = np.arange(12) % 3


def _inputs():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((16, 36))
    D /= np.linalg.norm(D, axis=0)
    X = rng.standard_normal((16, 12))
    return D.astype(np.float32), X.astype(np.float32)


# every public entry point, called on numpy inputs (or none) with no device
ENTRY_POINTS = {
    "batch_omp": lambda D, X, **kw: lt.batch_omp(D, X, 3, **kw),
    "omp": lambda D, X, **kw: lt.omp(D, X, 3, **kw),
    "group_omp": lambda D, X, **kw: lt.group_omp(
        D, X, np.repeat(np.arange(9), 4), 2, **kw),
    "nn_omp": lambda D, X, **kw: lt.nn_omp(D, np.abs(X), 3, **kw),
    "masked_omp": lambda D, X, **kw: masked_omp(D, X, np.ones_like(X), 3,
                                                **kw),
    "threshold_code": lambda D, X, **kw: lt.threshold_code(D, X, 0.1, **kw),
    "feature_sign": lambda D, X, **kw: lt.feature_sign(D, X, 0.2, **kw),
    "fista": lambda D, X, **kw: lt.fista(D, X, 0.2, n_iter=5, **kw),
    "llc": lambda D, X, **kw: lt.llc(D, X, 3, **kw),
    "encoder": lambda D, X, **kw: lt.SparseEncoder("bomp", {"T": 3},
                                                   **kw).encode(X, D),
    "denoise": lambda D, X, **kw: lt.denoise(
        np.full((12, 12), 100.0), np.asarray(lt.dct_dictionary(
            4, 16, device="cpu")), 20.0, cfg=lt.DenoiseConfig(patch=4),
        **kw),
    "inpaint": lambda D, X, **kw: inpaint(
        np.full((12, 12), 100.0), np.ones((12, 12)), np.asarray(
            lt.dct_dictionary(4, 16, device="cpu")), T=2, patch=4, **kw),
    "dct_dictionary": lambda D, X, **kw: lt.dct_dictionary(4, 16, **kw),
    "init_dictionary": lambda D, X, **kw: lt.init_dictionary(X, 8, **kw),
    "ksvd": lambda D, X, **kw: lt.KSVDLearner(
        lt.KSVDConfig(K=8, T=2, n_iter=1), **kw).fit(X).D_,
    "denoise_adaptive": lambda D, X, **kw: denoise_adaptive(
        np.full((12, 12), 100.0), 20.0, cfg=lt.DenoiseConfig(
            patch=4, sigma=20.0, T_max=2), K=16, n_iter=1, n_train=40,
        **kw),
    "dictionary_from_numpy": lambda D, X, **kw: dictionary_from_numpy(D,
                                                                      **kw),
    "denoiser_from_reference": lambda D, X, **kw: denoiser_from_reference(
        np.asarray(lt.dct_dictionary(4, 16, device="cpu")), {"patch": 4},
        **kw),
    "feature_sign_scan": lambda D, X, **kw: lt.feature_sign_scan(D, X, 0.2,
                                                                 **kw),
    "online_fit": lambda D, X, **kw: lt.OnlineDictionaryLearner(
        lt.OnlineDLConfig(K=8, batch_size=12, chunk_batches=1), **kw).fit(
        X).D_,
    "online_partial_fit": lambda D, X, **kw: lt.OnlineDictionaryLearner(
        lt.OnlineDLConfig(K=8), **kw).partial_fit(X).D_,
    "online_state_from_reference": lambda D, X, **kw:
        online_state_from_reference(D, np.eye(36), X[:, :1] @ np.ones(
            (1, 36)), **kw),
    "one_hot": lambda D, X, **kw: one_hot(LABELS, 3, **kw),
    "build_label_consistency": lambda D, X, **kw: build_label_consistency(
        LABELS, 6, 3, **kw),
    "linear_classifier": lambda D, X, **kw: lt.LinearClassifier(**kw).fit(
        X, LABELS).W_,
    "linear_svm": lambda D, X, **kw: lt.LinearSVM(n_iter=3, **kw).fit(
        X, LABELS).W_,
    "lcksvd": lambda D, X, **kw: lt.LCKSVD(
        lt.LCKSVDConfig(K=6, T=2, n_iter=2), **kw).fit(X, LABELS).D_,
    "lcksvd_from_reference": lambda D, X, **kw: lcksvd_from_reference(
        D, np.eye(36), np.ones((3, 36)), 3, **kw).D_,
    "src": lambda D, X, **kw: lt.SRCClassifier(T=2, **kw).fit(X, LABELS).D_,
    "src_from_reference": lambda D, X, **kw: src_from_reference(
        X, LABELS, 2, **kw).D_,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_numpy_in_without_gpu_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    D, X = _inputs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](D, X)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_device_cpu_runs_on_the_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    D, X = _inputs()
    out = ENTRY_POINTS[name](D, X, device="cpu")
    out = out[0] if isinstance(out, tuple) else out
    if isinstance(out, lt.Denoiser):
        out = out.D
    assert out.device.type == "cpu"


@pytest.mark.parametrize("route", ["bomp", "nn_omp", "llc", "lasso"])
def test_cpu_tensors_run_on_the_cpu(monkeypatch, route):
    # handing over CPU tensors asks for the CPU, even where a GPU exists
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    D, X = (torch.from_numpy(a) for a in _inputs())
    params = {"lasso": {"lam": 0.2}, "llc": {"knn": 3}}.get(route, {"T": 3})
    X = X.abs() if route == "nn_omp" else X
    assert lt.SparseEncoder(route, params).encode(X, D).device.type == "cpu"
    # a numpy signal matrix follows the dictionary tensor
    assert lt.batch_omp(D, X.numpy(), 3).device.type == "cpu"


def test_resolve_device_order(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # with a GPU present the default is cuda, and nothing is allocated
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device(None, np.zeros(3)) == torch.device("cuda")
    assert resolve_device("cpu", np.zeros(3)) == torch.device("cpu")
    assert resolve_device(None, np.zeros(3), torch.zeros(3)) \
        == torch.device("cpu")
    assert resolve_device(None, torch.zeros(3, device="meta")) \
        == torch.device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None, np.zeros(3))
