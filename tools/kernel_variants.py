#!/usr/bin/env python3
"""Time the fused selection (K7, csrc/select.cu) and the fused patch
pipeline (K3, csrc/fused_patches.cu) against variants of their constants
and against the parent commit's kernels, in turns, on one GPU.

    git archive HEAD lyssandra_tpu_torch | tar -x -C _archive/parent
    python3 tools/kernel_variants.py

Each variant is a copy of lyssandra_tpu_torch/ under _archive/variants/
(listed in .gitignore) with a few constants substituted; _archive/parent,
when present, is the parent's package as it was.  Every copy builds its own
library, all builds at once, and each copy is then timed in its own
process, in the order given and then in reverse (parent, change, ...,
change, parent).  K7 on the Batch-OMP benchmark's 262,144 lanes (p=64,
K=1024), float32 and bf16, its picks against the plain version; K3 on the
512^2 sigma=25 denoise image at p=8 (DC removal; + normalization; +
whitening) and p=7 (DC removal; + whitening), its outputs against the plain
version.  Each time is taken one call at a time (CUDA events) and in a CUDA
graph (chip_smoke.graph_ms: the device time without the host's launch
overhead).  Last, the K3 wrapper's host time a call: 1,000 calls on a 16^2
image at p=8, whose kernel takes a few microseconds, on the host's clock.
"""

import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "_archive", "variants")
PARENT = os.path.join(ROOT, "_archive", "parent")
SEL = "lyssandra_tpu_torch/csrc/select.cu"
LAUNCH_PY = "lyssandra_tpu_torch/ops/_launch.py"

STREAM = ("    if (bfr::fits(p, K)) {\n        switch",
          "    if (false) {\n        switch")
EPILOGUE = ("rising in (ni, e)\n#pragma unroll\n"
            "            for (int ni = 0; ni < NI; ++ni)")
RES_MMA = ("                        bf::mma_bf16(acc[mi][ni], a[mi][ks], "
           "b[ni][0],\n                                     b[ni][1]);")
# Each variant: file -> (old, new) substitutions.  The two "diagnostic"
# variants compute the wrong picks on purpose: they time the bf16 kernel
# with D resident with part of its work taken out.
VARIANTS = {
    "committed": {},
    "bf16 streaming D at every shape": {SEL: [STREAM]},
    "bf16 streaming, without the rotated walk": {SEL: [
        STREAM, ("const int kt0 = (int)(blockIdx.x % nk);",
                 "const int kt0 = 0;")]},
    "bf16 streaming, four chunks in flight": {SEL: [
        STREAM, ("constexpr int NSTAGE = 3;    // chunks",
                 "constexpr int NSTAGE = 4;    // chunks")]},
    "bf16 streaming, 256 rows a block": {SEL: [
        STREAM, ("constexpr int BM = 128;      // rows of r per block",
                 "constexpr int BM = 256;      // rows of r per block")]},
    "f32 one block an SM, no register cap": {SEL: [
        ("__launch_bounds__(BM * BN / (TM * TN), 2)",
         "__launch_bounds__(BM * BN / (TM * TN), 1)")]},
    "bf16 diagnostic: the epilogue on 1 of 8 n-tiles": {SEL: [
        (EPILOGUE, EPILOGUE.replace("ni < NI", "ni < 1"))]},
    "bf16 diagnostic: no mma": {SEL: [(RES_MMA, ";")]},
    "every launch entering torch.cuda.device": {LAUNCH_PY: [
        ("with kernel_device(like):",
         "with torch.cuda.device(like.device):")]},
}


def make_tree(name, subs):
    tree = os.path.join(OUT, "".join(c if c.isalnum() else "_"
                                     for c in name))
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "lyssandra_tpu_torch"),
                    os.path.join(tree, "lyssandra_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, pairs in subs.items():
        path = os.path.join(tree, rel)
        with open(path) as f:
            text = f.read()
        for old, new in pairs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {rel}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return tree


def measure(tree, tag):
    sys.path[:0] = [tree, ROOT]
    import numpy as np
    import torch

    import chip_smoke as cs
    from lyssandra_tpu_torch.ops import cuda_select
    from lyssandra_tpu_torch.ops.cuda_patches import (
        fused_patch_pipeline_p1, fused_patch_pipeline_reference,
    )
    from lyssandra_tpu_torch.utils.datasets import synthetic_image

    assert cuda_select.__file__.startswith(tree), cuda_select.__file__
    dev = torch.device("cuda", 0)

    def dt(a):
        return torch.as_tensor(a, device=dev)

    def graph_ms(fn):
        # a kernel library that calls cudaFuncSetAttribute on every launch
        # may not be capturable
        try:
            return f"{cs.graph_ms(torch, fn):.4f}"
        except RuntimeError as e:
            return f"not capturable ({str(e).splitlines()[0][:60]})"

    out = []
    Db, Xb = (dt(a) for a in cs.bench_problem())
    r = Xb.T.contiguous()
    for bf16 in (False, True):
        got = cuda_select.select_abs_argmax(r, Db, bf16=bf16)
        want = cuda_select.select_abs_argmax_reference(r, Db, bf16=bf16)
        agree = float((got == want).float().mean())
        one = cs.cuda_ms(torch, lambda: cuda_select.select_abs_argmax(
            r, Db, bf16=bf16), reps=7)
        graph = graph_ms(lambda: cuda_select.select_abs_argmax(
            r, Db, bf16=bf16))
        out.append(f"K7 {'bf16' if bf16 else 'f32'} {one:.4f}/{graph} "
                   f"(agree {agree:.6f})")
    rng = np.random.default_rng(0)
    img = synthetic_image("texture", 512, seed=0)
    noisy = dt((img + 25.0 * np.random.default_rng(0).standard_normal(
        img.shape)).astype(np.float32))
    whiten = {p: (dt(0.1 * rng.standard_normal((p * p, p * p))
                     .astype(np.float32)),
                  dt(rng.standard_normal(p * p).astype(np.float32)))
              for p in (8, 7)}
    for p, name, kw in ((8, "dc", {"do_dc": True}),
                        (8, "dc+norm", {"do_dc": True, "do_norm": True}),
                        (8, "whiten", {"do_dc": True, "do_norm": True,
                                       "whiten": whiten[8]}),
                        (7, "dc", {"do_dc": True}),
                        (7, "whiten", {"do_dc": True, "do_norm": True,
                                       "whiten": whiten[7]})):
        got = fused_patch_pipeline_p1(noisy, p, **kw)
        want = fused_patch_pipeline_reference(noisy, p, **kw)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        one = cs.cuda_ms(torch, lambda: fused_patch_pipeline_p1(
            noisy, p, **kw), reps=7)
        graph = graph_ms(lambda: fused_patch_pipeline_p1(noisy, p, **kw))
        out.append(f"K3 p={p} {name} {one:.4f}/{graph} (max |d| "
                   f"{err:.3g})")
    tiny = dt(rng.random((16, 16)).astype(np.float32))
    for _ in range(50):
        fused_patch_pipeline_p1(tiny, 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        fused_patch_pipeline_p1(tiny, 8)
    torch.cuda.synchronize()
    out.append(f"K3 wrapper host {(time.perf_counter() - t0) * 1e3:.1f} us "
               f"a call")
    print(tag, " | ".join(out), flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--measure":
        measure(*sys.argv[2:4])
        return
    trees = {}
    if os.path.isdir(PARENT):
        trees["parent"] = PARENT
    trees.update((name, make_tree(name, subs))
                 for name, subs in VARIANTS.items())
    build = ("import sys; sys.path.insert(0, '.'); "
             "from lyssandra_tpu_torch import _build; _build.build()")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=tree)
             for tree in trees.values()]
    if any(proc.wait() for proc in procs):
        raise SystemExit("a variant did not build")
    print("times in ms: one call / in a CUDA graph", flush=True)
    order = list(trees.items())
    for rnd, names in ((1, order), (2, order[::-1])):
        for name, tree in names:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--measure", tree,
                                 f"[{name}, run {rnd}]"]).returncode
            if rc:
                print(f"[{name}, run {rnd}] exited with {rc}", flush=True)


if __name__ == "__main__":
    main()
