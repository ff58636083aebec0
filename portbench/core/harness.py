"""One run of one cell: set-up, the measured window (and with trace a
traced one after it), the check against the plain reference, the metrics,
and the result line."""

import json
import math
import os
import sys
import time
from types import SimpleNamespace

from portbench.core import readers, spec
from portbench.core.program import sync
from portbench.core.trace import traced
from portbench.core.window import closed_loop

# compared by the top-level name (the part before the first dot), whole
FORBIDDEN = ("jax", "jaxlib", "flax", "lyssandra_tpu")
CACHE = spec.ROOT / ".portbench_cache"


class ForbiddenModules(RuntimeError):
    pass


def cache_env():
    """Fixed cache directories inside the checkout, set before torch is
    imported: the kernel library (built once per source state), and
    Triton's, PyTorch's extension and CUDA's JIT caches should anything
    use them."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")


def forbidden_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def guard():
    found = forbidden_modules()
    if found:
        raise ForbiddenModules("loaded in the measuring process: "
                               + ", ".join(found))


def prepare_program(devices):
    """Import the port, point its kernel library at the fixed cache and,
    on a GPU, build (first run in a checkout) and load it."""
    import torch

    import lyssandra_tpu_torch
    from lyssandra_tpu_torch import _build
    from lyssandra_tpu_torch.utils import enable_compile_cache

    enable_compile_cache(str(CACHE / "kernels"))
    if devices[0].type == "cuda":
        _build.load()
        for d in devices:
            torch.ones(1, device=d).sum().item()    # a context on each card
    torch.set_num_threads(4)
    return lyssandra_tpu_torch


def device_info(devices, chips):
    import torch

    if devices[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    idx = sorted({d.index for d in devices})
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(idx[0]),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in idx)}


def power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def run(name, seed, seconds, trace, *, devices, t_start, overrides=None,
        root=spec.ROOT):
    """One run; returns the result dict (the last key, ``checks``, holds
    each compared number with its limit)."""
    import torch

    cell = spec.Cell(name, root=root, overrides=overrides)
    tr_params = cell.traffic
    prepare_program(devices)
    entry = cell.entry_module().Entry(cell, seed, devices)
    entry.setup()
    setup_s = time.perf_counter() - t_start
    for i in {d.index for d in devices if d.type == "cuda"}:
        torch.cuda.reset_peak_memory_stats(i)

    window = closed_loop(entry.request, seconds,
                         min_requests=getattr(entry, "min_requests", 1))
    entry.window_closed()
    lat = sorted(window.latencies)
    print(f"portbench: window {window.seconds:.3f} s, {window.attempted} "
          f"requests, latency ms p50 {1e3 * lat[len(lat) // 2]:.3f} p95 "
          f"{1e3 * lat[int(0.95 * (len(lat) - 1))]:.3f} max "
          f"{1e3 * lat[-1]:.3f}", file=sys.stderr)
    dev_ms = entry.counters.get("device_ms")
    if dev_ms:
        print("portbench: on the device, ms " + " ".join(
            f"p{q} {readers.percentile(dev_ms, q):.3f}" for q in (50, 95, 99))
            + f" max {max(dev_ms):.3f}", file=sys.stderr)
    trace_obj = None
    attempted, failed = window.attempted, window.failed
    if trace:
        tw, trace_obj, reduce_s = traced(
            lambda: closed_loop(entry.request, seconds,
                                max_requests=tr_params["trace_requests"],
                                first=window.attempted),
            lambda: sync(devices))
        attempted += tw.attempted
        failed += tw.failed
        print(f"portbench: traced {tw.attempted} requests in "
              f"{trace_obj.window_s:.3f} s, reduced in {reduce_s:.1f} s",
              file=sys.stderr)
    guard()
    device = device_info(devices, cell.chips)
    if trace:
        device["busy_s"] = trace_obj.mean_busy_s(
            sorted({d.index for d in devices})) if device["platform"] == \
            "gpu" else 0.0
        device["window_s"] = trace_obj.window_s
    if device["platform"] == "gpu":
        device["power_limit"] = power_limit()
    entry.after_window(trace)
    entry.free()
    if device["platform"] == "gpu":
        torch.cuda.empty_cache()
    numbers = entry.check(cell.reference())
    limits = cell.limits()
    # a number that is not finite is written as null and fails
    checks = {k: {"value": float(v) if math.isfinite(v) else None,
                  "limit": limits[k]} for k, v in numbers.items()}
    correct = (failed == 0 and set(numbers) == set(limits) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    ctx = SimpleNamespace(cell=cell, entry=entry, window=window,
                          trace=trace_obj, setup_s=setup_s, chips=cell.chips,
                          devices=sorted({d.index for d in devices}))
    metrics = {}
    for m, reader in cell.metrics(trace):
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if trace and trace_obj is not None:
        result["breakdown"] = trace_obj.breakdown()
    result["checks"] = checks
    guard()
    return result


def emit(result):
    """The compared numbers as the last lines on standard error, and the
    result as the last line on standard output."""
    for k, c in result["checks"].items():
        ok = ("ok" if c["value"] is not None and c["value"] <= c["limit"]
              else "OVER")
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)

