#!/usr/bin/env python3
"""Time the residual-form OMP (K1-L, K2-L: cuda_omp.omp_residual_fused) and
the fused selection (K7, float32) of this tree against the parent commit's
and against variants of the residual form's sizing constants, in turns, on
one GPU.

    mkdir -p _archive/parent
    git archive HEAD lyssandra_tpu_torch | tar -x -C _archive/parent
    python3 tools/residual_ab.py

Each variant is a copy of lyssandra_tpu_torch/ under _archive/variants/
(listed in .gitignore) with a constant substituted; _archive/parent, when
present, is the parent's package as it was.  Every copy builds its own
library with ``-Xptxas -v``, all builds at once, and prints ptxas's
registers and spills for its float32 selection instances and its
residual-form kernels.  Each copy is then timed in its own process, in the
order given and then in reverse (parent, change, ..., change, parent):
K1-L and K2-L at path (t)'s shape (p=64, K=16,384, T=8, N=32,768 Gaussian
signals; K2-L at eps=0.3 with half the lanes scaled by 0.05), K1-L at
(s2)'s replicated omp (N=8,192) and at SRC's predict on (n2) (K=16,800,
N=7,200, T=10, Gaussian stand-ins), each against the plain version lane by
lane; and K7 at the Batch-OMP benchmark's shape (262,144 lanes, p=64,
K=1024), one call at a time and in a CUDA graph.  Times are CUDA-event
medians (chip_smoke.cuda_ms) in ms.
"""

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "_archive", "variants")
PARENT = os.path.join(ROOT, "_archive", "parent")
OMP_PY = "lyssandra_tpu_torch/ops/cuda_omp.py"

# Each variant: file -> (old, new) substitutions
VARIANTS = {
    "committed": {},
    "no atom split": {OMP_PY: [(
        "_SPLIT_BLOCKS = 8          #", "_SPLIT_BLOCKS = 0          #")]},
    "split to 16 blocks an SM": {OMP_PY: [(
        "_SPLIT_BLOCKS = 8          #", "_SPLIT_BLOCKS = 16         #")]},
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


def build(tree, tag):
    """Build the tree's library; print ptxas's lines for its float32
    selection kernels and its residual-form kernels."""
    sys.path.insert(0, tree)
    from lyssandra_tpu_torch import _build

    log = _build.build(("-Xptxas", "-v"))
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if re.search(
                r"f3213select_kernel|omp_residual", m.group(1)) else None
            continue
        if name and ("Used" in line or "spill" in line):
            m = re.search(r"(select|init|step)_kernelI[^E]*E[^E]*E", name)
            print(f"{tag} {m.group(0) if m else name[-48:]}: "
                  f"{line.split('ptxas info    :')[-1].strip()}", flush=True)


def measure(tree, tag):
    sys.path[:0] = [tree, ROOT]
    import numpy as np
    import torch

    import chip_smoke as cs
    from lyssandra_tpu_torch.ops import cuda_omp, cuda_select

    assert cuda_omp.__file__.startswith(tree), cuda_omp.__file__
    dev = torch.device("cuda", 0)

    def dt(a):
        return torch.as_tensor(a, device=dev)

    def gaussian(seed, p, K, N):
        rng = np.random.default_rng(seed)
        D = rng.standard_normal((p, K))
        D /= np.linalg.norm(D, axis=0, keepdims=True)
        return (dt(D.astype(np.float32)),
                dt(rng.standard_normal((p, N)).astype(np.float32)))

    out = []
    Dg, Xg = gaussian(21, 64, 16384, 32768)
    Xge = Xg.clone()
    Xge[:, ::2] *= 0.05
    Ds, Xs = gaussian(11, 64, 16384, 8192)
    Dn, Xn = gaussian(23, 64, 16800, 7200)
    for what, D, X, kw in (
            ("K1-L (t)", Dg, Xg, {"T": 8}),
            ("K2-L (t)", Dg, Xge, {"T": 8, "eps": 0.3, "eps_mode": True}),
            ("K1-L (s2) N=8192", Ds, Xs, {"T": 8}),
            ("K1-L (n2) K=16800 N=7200 T=10", Dn, Xn, {"T": 10})):
        h = cs.hold_lanes(torch, cuda_omp.omp_residual_fused(D, X, **kw),
                          cuda_omp.omp_fused_reference(D, X, **kw), X)
        ms = cs.cuda_ms(torch, lambda: cuda_omp.omp_residual_fused(
            D, X, **kw), reps=7)
        out.append(f"{what} {ms:.3f} (agree {h['agree']:.6f})")
    del Dg, Xg, Xge, Ds, Xs, Dn, Xn
    Db, Xb = (dt(a) for a in cs.bench_problem())
    r = Xb.T.contiguous()
    agree = float((cuda_select.select_abs_argmax(r, Db) ==
                   cuda_select.select_abs_argmax_reference(r, Db))
                  .float().mean())
    one = cs.cuda_ms(torch, lambda: cuda_select.select_abs_argmax(r, Db),
                     reps=7)
    graph = cs.graph_ms(torch, lambda: cuda_select.select_abs_argmax(r, Db))
    out.append(f"K7 f32 {one:.4f}/{graph:.4f} (agree {agree:.6f})")
    print(tag, " | ".join(out), flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] in ("--measure", "--build"):
        (measure if sys.argv[1] == "--measure" else build)(*sys.argv[2:4])
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    trees = {}
    if os.path.isdir(PARENT):
        trees["parent"] = PARENT
    trees.update((name, make_tree(name, subs))
                 for name, subs in VARIANTS.items())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--build", tree, f"[{name} ptxas]"],
                              stdout=subprocess.PIPE, text=True)
             for name, tree in trees.items()]
    logs = [proc.communicate()[0] for proc in procs]
    print("".join(logs), end="", flush=True)
    if any(proc.returncode for proc in procs):
        raise SystemExit("a variant did not build")
    print("times in ms (K7: one call / in a CUDA graph)", flush=True)
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
