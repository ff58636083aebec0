"""Tracing and timing hooks (``lyssandra_tpu.utils.profiling``
counterpart): ``profile_trace`` wraps a region in a ``torch.profiler``
trace written as a Chrome/Perfetto JSON file; ``timed`` times a call with
a device sync after each run."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Trace the region with ``torch.profiler`` (CPU ops, and the GPU's
    kernels where one is present) and write it to ``logdir/trace.json``, a
    Chrome/Perfetto trace, on exit.  A no-op when logdir is None."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _sync(tree: Any) -> None:
    """Wait for the GPUs that hold the tensors of ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, warmup: int = 1, reps: int = 3, **kw):
    """(result, seconds per call): ``warmup`` untimed calls (at least
    one), then the mean over ``reps`` calls, each waited for on its
    result's device."""
    for _ in range(max(warmup, 1)):
        _sync(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
        _sync(out)
    return out, (time.perf_counter() - t0) / reps
