"""The seam between the wrappers in ``ops/`` and the kernel library.

Each wrapper module owns one predicate per kernel, ``takes``: whether its
wrapper launches the kernel for these tensors and options.  The solvers ask
it and decide nothing else about devices, types or shapes.  A wrapper given
CUDA tensors that its predicate refuses raises through ``check_pair``.

Every launch goes through ``launch``: it loads the library
(``_build.load``), enters the tensor's GPU (``_device.kernel_device``),
passes the current stream as the entry point's last argument, turns a
non-zero return into an exception (``_build.check``) and adds one to the
launch's counter, one of the registry's fourteen; ``ops.launch_counts()``
reads them.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch._device import kernel_device

# launches so far in this process, by counter: K1 and K2 (omp_fused, by
# mode); K1-L and K2-L (omp_residual_fused: its init kernel by mode, one a
# chunk of lanes, and its selection and step kernels, T a chunk each); K3,
# K4/K5, K6, K8, K7, the product kernel, K9, the online sweep, and K10,
# K-SVD's sweep
_counts = dict.fromkeys((
    "omp_fused_t", "omp_fused_eps", "omp_residual_t", "omp_residual_eps",
    "omp_residual_select", "omp_residual_update", "fused_patches",
    "group_omp_fused", "fs_cold", "fs_scan", "select_abs_argmax", "gram",
    "online_sweep", "ksvd_sweep"), 0)


def count(counter: str) -> None:
    """One more launch on ``counter``."""
    _counts[counter] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for c in _counts:
        _counts[c] = 0


def kernel_types(device_type: str, *dtypes: torch.dtype) -> bool:
    """Whether a kernel may take operands of these types: on a GPU, every
    one float32."""
    return device_type == "cuda" and all(d == torch.float32 for d in dtypes)


def kernel_pair(D, X) -> bool:
    """``kernel_types`` of two tensors: both on a GPU, both float32.  A pair
    split over two GPUs passes here; ``check_pair`` refuses it."""
    return kernel_types("cuda" if D.is_cuda and X.is_cuda else "cpu",
                        D.dtype, X.dtype)


def check_pair(D: torch.Tensor, X: torch.Tensor, takes, limit: str,
               **opts) -> None:
    """Raise ValueError unless a kernel takes D (p, K) and X (p, N): both
    float32 on one GPU, and ``takes(D, X, **opts)``, the wrapper's
    predicate (else the error names the kernel's ``limit`` and the call's
    p, K and ``opts``)."""
    if not (X.is_cuda and D.is_cuda and X.device == D.device):
        raise ValueError(
            f"no kernel for D on {D.device} and X on {X.device}")
    if X.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError(f"kernel takes float32, got {D.dtype}, {X.dtype}")
    if X.ndim != 2 or D.ndim != 2 or X.shape[0] != D.shape[0]:
        raise ValueError(
            f"D (p, K) and X (p, N) expected, got {tuple(D.shape)} and "
            f"{tuple(X.shape)}")
    if not takes(D, X, **opts):
        p, K = D.shape
        got = "".join(f", {k}={v}" for k, v in opts.items())
        raise ValueError(f"kernel takes {limit}; got p={p}, K={K}{got}")


def launch(counter: str, entry: str, *args, like: torch.Tensor) -> None:
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``like``'s GPU, raise if it reports a CUDA error, and count the launch
    on ``counter``."""
    lib = _build.load()
    with kernel_device(like):
        code = getattr(lib, entry)(
            *args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, entry)
    count(counter)
