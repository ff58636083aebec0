"""Where a public entry point runs.

The port runs on the GPU unless the caller asks for the CPU.  A caller asks
by naming the device, or by handing over tensors that lie there; numpy
inputs with no device go to the GPU.  There is no silent CPU fallback: with
no device named, no tensor input and no GPU, the call raises.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None, *inputs) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else that of
    the first tensor among ``inputs``, else ``cuda`` when a GPU exists."""
    if device is not None:
        return torch.device(device)
    for a in inputs:
        if isinstance(a, torch.Tensor):
            return a.device
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")


def kernel_device(t: torch.Tensor):
    """The context a kernel launch for the CUDA tensor ``t`` runs in: none
    when ``t``'s GPU is already the current one (the usual case, and the
    cheaper one on the host), else ``torch.cuda.device(t.device)``, so that
    the kernel and the current stream are ``t``'s."""
    if t.device.index is None or t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)
