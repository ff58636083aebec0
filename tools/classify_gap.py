#!/usr/bin/env python3
"""Config 5's accuracies with the fused OMP kernel (K1) against those with
its plain version, beside the gaps that rounding alone and a faulty K1 make,
on one GPU.

    python3 tools/classify_gap.py [seed ...]     (default: seeds 0 1 2)

For each seed of chip_smoke.digits_problem (the digits stand-in: 1,257
training and 540 test images in 10 classes), LC-KSVD (K=500, T=8, 20
iterations) is fitted and scored and SRC (T=10) scored once for each coder
put in the place of ops/cuda_omp.omp_fused, as chip_smoke.py's path (n)
swaps it:

  K1            the kernel;
  plain         its plain version (the residual form) in float32;
  plain f64     the plain version in float64, its outputs cast to float32:
                a sound coder that rounds otherwise;
  swap 1%/5%    the kernel, with every 100th (20th) lane given the next
                lane's result, as a fault in the lane indexing would;
  drop 5%       the kernel, with the last coefficient of every 20th lane
                zeroed, as a fault in the last step's write would.

Each line gives the accuracies, their gaps to the plain pipeline's and the
stacked K-SVD objective at the first and the last iteration beside the
plain pipeline's.  In the K1 pipeline every call is also held lane by lane
against the plain version on the same inputs (chip_smoke.hold_lanes: the
lanes whose picks part, |dgamma| where they agree), and K1 on the stacked
coding (p = 64 + K + C) from the learned stacked dictionary against the
plain version in float32 and float64, as chip_smoke.py's path (n) holds
it.  The last line is one JSON object of all of it.
"""

import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def coders(torch, cuda_omp, hold_lanes, calls):
    """The coders by name; "K1" also appends, for each call, its lanes held
    against the plain version on the same inputs to ``calls``."""
    kernel = cuda_omp.omp_fused
    plain = cuda_omp.omp_fused_reference

    def traced(D, X, **kw):
        got = kernel(D, X, **kw)
        calls.append(hold_lanes(torch, got, plain(D, X, **kw), X))
        return got

    def plain64(D, X, **kw):
        idx, gamma, err, nsel = plain(D.double(), X.double(), **kw)
        return idx, gamma.float(), err.float(), nsel

    def swapped(every):
        def run(D, X, **kw):
            out = [a.clone() for a in kernel(D, X, **kw)]
            lanes = torch.arange(0, out[0].shape[0] - 1, every,
                                 device=X.device)
            for a in out:
                a[lanes] = a[lanes + 1]
            return tuple(out)
        return run

    def dropped(every):
        def run(D, X, **kw):
            idx, gamma, err, nsel = kernel(D, X, **kw)
            gamma = gamma.clone()
            gamma[::every, -1] = 0.0
            return idx, gamma, err, nsel
        return run

    table = {"K1": traced, "plain": plain, "plain f64": plain64,
             "swap 1%": swapped(100), "swap 5%": swapped(20),
             "drop 5%": dropped(20)}
    # the kernel's wrapper counts its launches on whatever the module's
    # name omp_fused holds, so each stand-in carries the two counters
    for coder in table.values():
        for count in ("launches_t", "launches_eps"):
            if not hasattr(coder, count):
                setattr(coder, count, 0)
    return table


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/classify_gap.py needs a CUDA device")
    import chip_smoke
    import lyssandra_tpu_torch as lt
    from lyssandra_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    gpu = smi.stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    cuda_omp = importlib.import_module("lyssandra_tpu_torch.ops.cuda_omp")
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    seeds = [int(s) for s in sys.argv[1:]] or [0, 1, 2]
    dev = torch.device("cuda", 0)
    cfg = lt.LCKSVDConfig(K=chip_smoke.LC_K, T=8, n_iter=chip_smoke.LC_ITERS)
    real = cuda_omp.omp_fused
    calls = []
    table = coders(torch, cuda_omp, chip_smoke.hold_lanes, calls)
    results = []
    for seed in seeds:
        Xtr, ytr, Xte, yte = chip_smoke.digits_problem(seed=seed)
        Xtr = torch.as_tensor(Xtr, device=dev)
        Xte = torch.as_tensor(Xte, device=dev)
        row = {}
        for name, coder in table.items():
            calls.clear()
            cuda_omp.omp_fused = coder
            try:
                t1 = time.perf_counter()
                lc = lt.LCKSVD(cfg).fit(Xtr, ytr)
                acc_lc = lc.score(Xte, yte)
                acc_src = lt.SRCClassifier(T=chip_smoke.SRC_T).fit(
                    Xtr, ytr).score(Xte, yte)
                secs = time.perf_counter() - t1
            finally:
                cuda_omp.omp_fused = real
            objs = [h["objective"] for h in lc.history_]
            row[name] = {"lcksvd": acc_lc, "src": acc_src,
                         "objectives": objs, "seconds": secs}
            if name == "K1":
                # the fit's 21 codings (ridge init, 20 stacked iterations),
                # the predict and SRC, each held against the plain version
                row[name]["calls"] = [dict(c) for c in calls]
                print(f"seed {seed} K1 calls against the plain version on "
                      f"the same inputs: lanes that part "
                      f"{[c['lanes_differ'] for c in calls]}, max "
                      f"|dgamma|/||x|| where the picks agree "
                      f"{max(c['gamma_rel'] for c in calls):.3g}",
                      flush=True)
                row[name]["stacked_lanes"] = chip_smoke.hold_k1(
                    torch, cuda_omp,
                    *chip_smoke.lcksvd_stacked(torch, lc, Xtr, ytr), cfg.T)
                print(f"seed {seed} K1 on the stacked coding from the "
                      f"learned D~: {row[name]['stacked_lanes']}",
                      flush=True)
        base = row["plain"]["objectives"]
        for name, r in row.items():
            r["lcksvd_gap"] = r["lcksvd"] - row["plain"]["lcksvd"]
            r["src_gap"] = r["src"] - row["plain"]["src"]
            r["objective_rel_gap"] = [abs(a - b) / b for a, b in
                                      zip(r["objectives"], base)]
            gap = r["objective_rel_gap"]
            print(f"seed {seed} {name:9s}: LC-KSVD {r['lcksvd']:.4f} "
                  f"({r['lcksvd_gap']:+.4f}), SRC {r['src']:.4f} "
                  f"({r['src_gap']:+.4f}); stacked objective "
                  f"{r['objectives'][0]:.6f} -> {r['objectives'][-1]:.6f}, "
                  f"relative to the plain pipeline's {gap[0]:.2g} at the "
                  f"first iteration, {gap[-1]:.2g} at the last;"
                  f" {r['seconds']:.1f} s", flush=True)
        results.append({"seed": seed, "pipelines": row})
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": gpu, "results": results}))


if __name__ == "__main__":
    main()
