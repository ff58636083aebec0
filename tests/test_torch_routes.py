"""Which function computes a solver's call: the kernel's wrapper or the
plain path.  Each case runs on CPU tensors and on CPU tensors that pose as
CUDA ones (``Tensor.is_cuda`` patched true), at a shape inside and one
outside the kernel's envelope.  The wrappers are replaced by spies that
run their plain versions, so no kernel launches; the plain paths by spies
that run the originals.  A route that takes two steps, feature_sign's
cold start and then its loop, names both, joined by "+"."""

import importlib

import numpy as np
import pytest
import torch

from lyssandra_tpu_torch.ops import (
    cuda_fs, cuda_fs_scan, cuda_group, cuda_omp, cuda_select,
)
from lyssandra_tpu_torch.solvers import greedy

tl = importlib.import_module("lyssandra_tpu_torch.solvers.lasso")

torch.set_num_threads(1)

LAM = 0.2

# (entry, shape) -> the route on CPU tensors and on tensors posing as CUDA
ROUTES = {
    ("batch_omp", "inside"): ("plain", "omp_fused"),
    ("batch_omp", "residual"): ("plain", "omp_residual_fused"),
    ("batch_omp", "outside"): ("plain", "plain"),
    ("omp_fused_select", "inside"): ("select", "select"),
    ("omp_fused_select", "outside"): ("plain", "plain"),
    ("omp_fused_select", "float64"): ("plain", "plain"),
    ("group_omp", "inside"): ("plain", "group"),
    ("group_omp", "outside"): ("plain", "plain"),
    ("group_omp", "eps"): ("plain", "plain"),
    ("feature_sign_pallas", "inside"): ("fs_cold+loop",
                                        "fs_cold+fs_scan_seeded"),
    ("feature_sign_pallas", "outside"): ("fs_cold+loop",
                                         "plain+fs_scan_seeded"),
    ("feature_sign_pallas", "n_activate-2"): ("fs_cold+loop", "fs_cold+loop"),
    ("feature_sign_xla", "inside"): ("plain+loop", "plain+fs_scan_seeded"),
    ("feature_sign_xla", "outside"): ("plain+loop", "plain+fs_scan_seeded"),
    ("feature_sign_scan", "inside"): ("plain", "fs_scan"),
    ("feature_sign_scan", "outside"): ("plain", "plain"),
    ("feature_sign_scan", "n_activate-2"): ("plain", "plain"),
}


def _unit(rng, p, K):
    D = rng.standard_normal((p, K)).astype(np.float32)
    return torch.from_numpy(D / np.linalg.norm(D, axis=0))


def _spy(monkeypatch, module, name, tag, calls, fn=None):
    """Replace ``module.name`` by a function that records ``tag`` and runs
    ``fn`` (default: the original)."""
    run = fn or getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(tag)
        if fn is not None:
            # a wrapper's products: its plain version makes its own
            kwargs.pop("products", None)
        return run(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


# the plain path's markers, by entry: (module, function, tag)
PLAIN = {
    "batch_omp": ((greedy, "_omp_impl", "plain"),
                  (greedy, "_batch_omp_impl", "plain")),
    "omp_fused_select": ((greedy, "_argmax_abs", "plain"),),
    "group_omp": ((greedy, "_group_omp_impl", "plain"),),
    "feature_sign_pallas": ((tl, "_fs_unrolled_state", "plain"),
                            (tl, "_fs_segments", "loop")),
    "feature_sign_xla": ((tl, "_fs_unrolled_state", "plain"),
                         (tl, "_fs_segments", "loop")),
    "feature_sign_scan": ((tl, "_fs_loop", "plain"),),
}


def _spies(monkeypatch, entry):
    calls = []
    for module, name, tag, fn in (
        (cuda_omp, "omp_fused", "omp_fused", cuda_omp.omp_fused_reference),
        (cuda_omp, "omp_residual_fused", "omp_residual_fused",
         cuda_omp.omp_fused_reference),
        (cuda_select, "select_abs_argmax", "select",
         cuda_select.select_abs_argmax_reference),
        (cuda_group, "group_omp_fused", "group",
         cuda_group.group_omp_fused_reference),
        (cuda_fs, "fs_cold_fused", "fs_cold",
         cuda_fs.fs_cold_fused_reference),
        (cuda_fs_scan, "fs_scan_fused", "fs_scan",
         cuda_fs_scan.fs_scan_fused_reference),
        (cuda_fs_scan, "fs_scan_seeded", "fs_scan_seeded",
         cuda_fs_scan.fs_scan_seeded_reference),
    ) + tuple((m, n, tag, None) for m, n, tag in PLAIN[entry]):
        _spy(monkeypatch, module, name, tag, calls, fn)
    return calls


def _call(entry, shape, rng):
    if entry == "batch_omp":
        # the Gram form's cap at p=64, T=8 is 12,304 atoms; the residual
        # form's p <= 512
        p, K = {"inside": (64, 256), "residual": (64, 12305),
                "outside": (513, 20000)}[shape]
        greedy.batch_omp(_unit(rng, p, K), torch.randn(p, 6), 8)
    elif entry == "omp_fused_select":
        p = 513 if shape == "outside" else 16      # the kernel's p <= 512
        D, X = _unit(rng, p, 40), torch.randn(p, 6)
        if shape == "float64":
            D, X = D.double(), X.double()
        greedy._omp_impl(D, X, 0.0, T=3, eps_mode=False, fused_select=True)
    elif entry == "group_omp":
        gs = 9 if shape == "outside" else 4        # the kernel's gs <= 8
        groups = np.repeat(np.arange(5), gs)
        greedy.group_omp(_unit(rng, 16, 5 * gs), torch.randn(16, 6), groups,
                         2, eps=0.1 if shape == "eps" else None)
    elif entry in ("feature_sign_pallas", "feature_sign_xla"):
        backend = entry.rsplit("_", 1)[1]
        unroll = 33 if shape == "outside" else 3   # the kernel's <= 32
        tl.feature_sign(_unit(rng, 12, 24), torch.randn(12, 6), LAM,
                        max_iter=4, cold_unroll=unroll, cold_backend=backend,
                        n_activate=2 if shape == "n_activate-2" else 1)
    else:
        active = 65 if shape == "outside" else 64  # the kernel's <= 64
        tl.feature_sign_scan(_unit(rng, 12, 24), torch.randn(12, 6), LAM,
                             max_iter=4, max_active=active,
                             n_activate=2 if shape == "n_activate-2" else 1)


@pytest.mark.parametrize("posed", [False, True], ids=["cpu", "posed-cuda"])
@pytest.mark.parametrize("entry, shape", list(ROUTES),
                         ids=["-".join(k) for k in ROUTES])
def test_route_table(monkeypatch, rng, entry, shape, posed):
    calls = _spies(monkeypatch, entry)
    if posed:
        monkeypatch.setattr(torch.Tensor, "is_cuda",
                            property(lambda self: True))
    _call(entry, shape, rng)
    want = ROUTES[entry, shape][posed]
    assert calls and set(calls) == set(want.split("+")), calls
