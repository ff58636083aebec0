#!/usr/bin/env python3
"""Where the time of the group-OMP and lasso encoders and of a K-SVD
iteration goes on one GPU.

    python3 tools/profile_encoders.py

Traces one warm call of each main path with ``torch.profiler`` (CPU and
CUDA activity): path (b), ``SparseEncoder("group_omp")`` (T=4, 256 groups
of 4) on the Batch-OMP benchmark's 262,144 signals, path (d),
``SparseEncoder("lasso", {"lam": 0.15})`` on config 4's 16,384 patches,
and path (i), one K-SVD iteration (``ksvd_step``) and one atom sweep at
config 2's width (the inputs ``chip_smoke.py`` makes).  For each it prints
the host wall time of the call (ended by a synchronize), the device's busy
time (the union of the kernel and copy intervals) and idle share, the host
syncs the lasso solver counted, the kernel launches traced, and the device
time by kernel, largest first.
"""

import math
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def short(name):
    """A kernel's name without its namespace and argument list."""
    for tag in ("fs_cold_kernel", "group_omp_kernel", "gram_kernel",
                "omp_fused_kernel", "select_kernel", "fused_patches_kernel"):
        if tag in name:
            return tag
    return name if len(name) <= 70 else name[:67] + "..."


def profile_call(torch, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench.core.trace import _union

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(float)
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        by_name[short(e.name)] += (end - start) / 1e3
        spans.append((start, end))
    busy = sum(e - s for s, e in _union(spans, -math.inf, math.inf))
    return wall_ms, busy / 1e3, by_name, len(spans)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_encoders: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    import lyssandra_tpu_torch as lt
    from lyssandra_tpu_torch.solvers.lasso import host_syncs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    Db, Xb = chip_smoke.bench_problem()
    Db, Xb = torch.as_tensor(Db, device=dev), torch.as_tensor(Xb, device=dev)
    D4, X4 = chip_smoke.config4_problem()
    D4, X4 = torch.as_tensor(D4, device=dev), torch.as_tensor(X4, device=dev)
    groups = np.repeat(np.arange(chip_smoke.K // chip_smoke.GS),
                       chip_smoke.GS)
    genc = lt.SparseEncoder("group_omp", {"T": chip_smoke.T_GROUP,
                                          "groups": groups})
    lenc = lt.SparseEncoder("lasso", {"lam": chip_smoke.LAM})
    import importlib

    from lyssandra_tpu_torch.utils.datasets import (
        patch_dataset, standard_test_image,
    )

    ksvd = importlib.import_module("lyssandra_tpu_torch.dict_learning.ksvd")
    imgs = [standard_test_image(n, chip_smoke.KSVD_IMG)
            for n in ("barbara", "lena")]
    X2 = torch.as_tensor(patch_dataset(imgs, p=8, n_patches=chip_smoke.KSVD_N)
                         .astype(np.float32), device=dev)
    cfg2 = lt.KSVDConfig(K=chip_smoke.KSVD_K, T=8)
    kenc = lt.SparseEncoder("bomp", {"T": 8}, check_atoms=False)
    D2 = lt.init_dictionary(X2, cfg2.K, cfg2.init, cfg2.seed)
    G2 = kenc.encode(X2, D2)
    paths = (("(b) group_omp encoder N=262144",
              lambda: genc.encode(Xb, Db, dense=False)),
             ("(d) lasso encoder N=16384", lambda: lenc.encode(X4, D4)),
             (f"(i) ksvd_step N={chip_smoke.KSVD_N} K={cfg2.K}",
              lambda: ksvd.ksvd_step(X2, D2, kenc, cfg2)),
             (f"(i) ksvd_atom_update N={chip_smoke.KSVD_N} K={cfg2.K}",
              lambda: ksvd.ksvd_atom_update(X2, D2, G2)))
    for what, fn in paths:
        syncs0 = host_syncs()
        wall, busy, by_name, launches = profile_call(torch, fn)
        # two calls ran: the warm-up and the traced one
        syncs = (host_syncs() - syncs0) // 2
        print(f"{what}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
              f"share {1.0 - busy / wall:.4f}; host syncs per call {syncs}; "
              f"{launches} device operations")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:9.3f} ms  {100.0 * ms / busy:5.1f}%  {name}")


if __name__ == "__main__":
    main()
