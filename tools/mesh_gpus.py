#!/usr/bin/env python3
"""The device mesh across every GPU of one machine.

    python3 tools/mesh_gpus.py

Runs ``chip_smoke.mesh_paths``, path (s) of ``chip_smoke.py``, with the
mesh's slots spread over all visible GPUs in turn instead of several slots
of one: (s1) ``SparseEncoder("bomp", mesh=)`` on ``make_mesh()`` (every
GPU on 'data') and on 4 slots, (s2) ``omp_model_sharded`` on 2x4 slots,
(s3) the sharded K-SVD step, the atom-sharded step on 2x2 slots and
``KSVDLearner(mesh=)``, (s4) the sharded denoise, (s5) the sharded online
fit, each held against the unsharded call on cuda:0 with path (s)'s
tolerances.  Inputs and results lie on cuda:0; every other slot's shard
is a peer copy.  Then it times the real 4-slot bomp encode, with the
slots on 4 GPUs and on cuda:0 alone, and the unsharded encode: the whole
call and the host's enqueue (host clock, every GPU synchronized), and one
call traced with ``torch.profiler`` (each GPU's busy, kernel and copy
time, the host's CUDA runtime calls).  Prints each GPU's name and power
limit, the path's lines, and as its last line one JSON object of the
results.  Needs at least two GPUs, and raises without.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import numpy as np
    import torch

    sys.stdout.reconfigure(line_buffering=True)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        raise SystemExit(f"mesh_gpus: needs two GPUs or more, found {n}")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lyssandra_tpu_torch as lt
    from lyssandra_tpu_torch import _build
    from lyssandra_tpu_torch.utils.datasets import synthetic_image

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    cards = smi.stdout.strip().splitlines()
    for i, line in enumerate(cards):
        print(f"cuda:{i}: {line}")
    card = f"{n} x {cards[0]}"
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s")

    Db, Xb = cs.bench_problem()
    Db, Xb = torch.as_tensor(Db, device=dev), torch.as_tensor(Xb, device=dev)
    img = synthetic_image("texture", cs.IMG_SIZE, seed=0)
    noisy = img + cs.SIGMA * np.random.default_rng(0).standard_normal(
        img.shape)
    img_d = torch.as_tensor(img.astype(np.float32), device=dev)
    noisy = torch.as_tensor(noisy.astype(np.float32), device=dev)
    Dd = lt.dct_dictionary(8, 256, device=dev)
    gpus = [torch.device("cuda", i) for i in range(n)]
    t0 = time.perf_counter()
    launches, out = cs.mesh_paths(torch, lt, dev, card, Db, Xb, Dd, img_d,
                                  noisy, gpus=gpus)
    print(f"path (s) on {n} GPUs: {time.perf_counter() - t0:.1f} s, "
          f"launches {launches}")
    out["profile"] = {
        name: profile_encode(torch, lt, Db, Xb, slot_devs, n)
        for name, slot_devs in (
            ("unsharded", None), ("4 slots on cuda:0", [dev] * 4),
            (f"4 slots on {min(n, 4)} GPUs",
             [gpus[i % n] for i in range(4)]))}
    for name, r in out["profile"].items():
        print(f"[{card}] bomp encode N={Xb.shape[1]}, {name}: whole call "
              f"{r['whole_ms']:.3f} ms, enqueue {r['enqueue_ms']:.3f} ms "
              f"(host clock); traced: " + "; ".join(
                  f"{g} busy {v.get('busy_ms', 0.0):.3f} ms, kernels "
                  f"{v['kernel_ops']} {v['kernel_ms']:.3f} ms, copies "
                  f"{v['copy_ops']} {v['copy_ms']:.3f} ms"
                  for g, v in sorted(r["gpus"].items())) + "; runtime "
              + ", ".join(f"{k} {c} {ms:.3f} ms" for k, (c, ms) in
                          sorted(r["runtime"].items(),
                                 key=lambda kv: -kv[1][1])[:4]))
    print(json.dumps({"gpus": cards, "mesh": out}))


def host_ms(torch, n, fn, reps=7):
    """Medians over warm runs of (the whole call, its enqueue) in ms, host
    clock, every GPU synchronized after the call."""
    def sync_all():
        for i in range(n):
            torch.cuda.synchronize(i)

    fn()
    sync_all()
    whole, enqueue = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        sync_all()
        t2 = time.perf_counter()
        whole.append((t2 - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    return statistics.median(whole), statistics.median(enqueue)


def profile_encode(torch, lt, Db, Xb, slot_devs, n):
    """The bomp encode of Xb (T=8), the real ``SparseEncoder`` call: on a
    4-slot mesh over ``slot_devs``, or unsharded for None.  Its (whole,
    enqueue) by host_ms, then one warm call traced with ``torch.profiler``:
    per GPU its busy time (the union of its kernel and copy intervals), its
    kernel and copy time and operations, and the host's calls into the
    CUDA runtime (count and ms by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lyssandra_tpu_torch.parallel import make_mesh

    mesh = None if slot_devs is None else make_mesh(data=4,
                                                     devices=slot_devs)
    enc = lt.SparseEncoder("bomp", {"T": 8}, mesh=mesh)

    def call():
        return enc.encode(Xb, Db, dense=False)

    whole, enqueue = host_ms(torch, n, call)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        for i in range(n):
            torch.cuda.synchronize(i)
    spans, gpus, runtime = {}, {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kind = "copy" if "memcpy" in e.name.lower() else "kernel"
            g = gpus.setdefault(f"cuda:{e.device_index}", {
                "kernel_ms": 0.0, "kernel_ops": 0, "copy_ms": 0.0,
                "copy_ops": 0})
            g[f"{kind}_ms"] += (e.time_range.end - e.time_range.start) / 1e3
            g[f"{kind}_ops"] += 1
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
        elif e.name.startswith("cuda"):
            r = runtime.setdefault(e.name, [0, 0.0])
            r[0] += 1
            r[1] += e.cpu_time_total / 1e3
    for i, sp in spans.items():
        busy, last = 0.0, None
        for a, b in sorted(sp):
            if last is None or a > last:
                busy, last = busy + b - a, b
            elif b > last:
                busy, last = busy + b - last, b
        gpus[f"cuda:{i}"]["busy_ms"] = busy / 1e3
    return {"whole_ms": whole, "enqueue_ms": enqueue, "gpus": gpus,
            "runtime": runtime}


if __name__ == "__main__":
    main()
