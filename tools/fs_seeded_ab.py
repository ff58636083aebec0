#!/usr/bin/env python3
"""The search kernel's seeded entry (K8 from K6's handoff,
``ops/cuda_fs_scan.fs_scan_seeded``) against the plain loop from the same
handoff, on one GPU, at p=192, K=1,024, lam 0.15, at the lasso encoder's
block (2,048 lanes) and the stream cell's minibatch (4,096), over two
dictionaries: config 4's data dictionary (``chip_smoke.config4_problem``;
K6 at 28 steps and at 4, which leaves most lanes to the loop) and the one
the lasso cell learns (``portbench/configs/lasso-c4.py``'s learner over the
cell's training set; the cell's first pool set's patches; K6 at 28).

    python3 tools/fs_seeded_ab.py [--parent DIR]

For each case: the lanes done at the handoff; the kernel's codes held lane
by lane against the plain loop's (objective gap, KKT breach of the optimal
lanes, done and overflow flags, the lanes done on entry bit for bit); the
largest lane count; device times by CUDA events (median of 5 warm calls):
K6 with its two products, the seeded kernel alone, both, and the plain
loop; and the bound of the whole solve (chip_smoke.py's K8 bound: alpha0,
the Gram columns of the atoms used, per lane the gradient and KKT test at
its support and one Cholesky solve).

With ``--parent DIR`` (the root of another checkout): DIR's
``lyssandra_tpu_torch/csrc/fs_scan.cu`` is built apart, and K8's
empty-start entry of both builds runs on the online fit's 1,024-lane
coding block; the outputs must agree bit for bit, and cuobjdump's SASS of
the two empty-start kernels is compared instruction by instruction.  The
last line is one JSON object of all of it.
"""

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NS = (2048, 4096)
N_FIT = 1024             # the online fit's coding block (4,096 in 4)


def digest(*tensors):
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def sass(lib_path, pattern):
    """The instructions of the one kernel whose name matches ``pattern`` in
    cuobjdump's SASS of ``lib_path``: addresses and encodings dropped."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    blocks = re.split(r"\n\s*Function : ", out)
    found = [b for b in blocks[1:] if re.match(pattern, b.split("\n", 1)[0])]
    if len(found) != 1:
        raise SystemExit(f"{len(found)} kernels match {pattern!r}")
    lines = []
    for line in found[0].split("\n")[1:]:
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\*", line)
        if m:
            lines.append(m.group(1))
    return lines


def parent_case(torch, parent, D, X, lam):
    """K8's empty-start entry of this tree's build and of ``parent``'s
    csrc/fs_scan.cu, built apart, on (D, X): their outputs' digests and
    SASS."""
    from lyssandra_tpu_torch import _build
    from lyssandra_tpu_torch.ops.cuda_fs import gram_inputs, kkt_thresholds
    from lyssandra_tpu_torch.ops.cuda_fs_scan import fs_scan_fused

    src = os.path.join(parent, "lyssandra_tpu_torch", "csrc", "fs_scan.cu")
    out_dir = _build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libparent_fs_scan.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), src], check=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    lib.lyssa_fs_scan.argtypes = _build._SIGNATURES["lyssa_fs_scan"]
    lib.lyssa_fs_scan.restype = ctypes.c_int
    K, N = D.shape[1], X.shape[1]
    A0, G = gram_inputs(D, X)
    gamma = torch.zeros((N, K), dtype=torch.float32, device=D.device)
    done = torch.zeros(N, dtype=torch.bool, device=D.device)
    ovf = torch.zeros(N, dtype=torch.bool, device=D.device)
    code = lib.lyssa_fs_scan(
        A0.data_ptr(), G.data_ptr(), K, N, 64, 60, 6, 32, lam,
        *kkt_thresholds(lam), gamma.data_ptr(), done.data_ptr(),
        ovf.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise SystemExit(f"parent lyssa_fs_scan: CUDA error {code}")
    got = fs_scan_fused(D, X, lam=lam)
    torch.cuda.synchronize()
    ours = sass(_build.library_path(),
                r"_ZN\S*14fs_scan_kernelILb0EE")
    theirs = sass(lib_path, r"_ZN\S*14fs_scan_kernelE")
    differ = sum(a != b for a, b in zip(ours, theirs)) + abs(
        len(ours) - len(theirs))
    return {"lanes": N, "digest": digest(*got[:3]),
            "parent_digest": digest(gamma.T, done, ovf),
            "equal": bool(torch.equal(got[0], gamma.T)
                          and torch.equal(got[1], done)
                          and torch.equal(got[2], ovf)),
            "sass_instructions": [len(ours), len(theirs)],
            "sass_lines_differing": differ}


def learned(torch, dev):
    """The lasso cell's dictionary, learned as its set-up learns it, and
    the first pool set's patches (unit norm), both float32 on ``dev``."""
    from portbench.core import spec
    from portbench.yardstick import color

    cell = spec.Cell("lasso-c4.encode")
    cfg = cell.config
    train = torch.from_numpy(
        color.unit_patches(cfg)[:, :cfg["n_train"]]).to(dev)
    D = cell.reference().learn(train, cfg).to(torch.float32).contiguous()
    imgs = [color.synthetic_color_image(k, cfg["image"], seed=s)
            for s, k in enumerate(cfg["images"])]
    X = color.patches(imgs, cfg["patch"], max(NS),
                      cfg["pool_seeds"][0]).astype(np.float32)
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-8)
    return D, torch.from_numpy(X).to(dev)


def case(torch, cs, D, X, lam, tun):
    """The seeded entry from K6's handoff at ``tun`` steps against the
    plain loop from it, on (D, X): agreement, lane counts and times."""
    from lyssandra_tpu_torch.ops.cuda_fs import fs_cold_fused, gram_inputs
    from lyssandra_tpu_torch.ops.cuda_fs_scan import (
        fs_scan_seeded, fs_scan_seeded_reference,
    )
    from portbench.yardstick.peaks import bound_ms

    n = X.shape[1]
    products = gram_inputs(D, X)
    seed = fs_cold_fused(D, X, lam=lam, t_unroll=tun, products=products)
    G, done, ovf, iters = fs_scan_seeded(D, X, seed, lam=lam,
                                         products=products)
    Gp, donep, ovfp, itp = fs_scan_seeded_reference(D, X, seed, lam=lam)
    torch.cuda.synchronize()
    fo = cs.lasso_objectives(torch, D, X, G, lam)
    fw = cs.lasso_objectives(torch, D, X, Gp, lam)
    gap = (fo - fw) / fw.clamp_min(1e-12)
    kkt = cs.lasso_kkt_lanes(torch, D, X, G, lam)[done & ~ovf]
    entry = seed[5]
    c = (Gp != 0).sum(dim=0).double()
    atoms = int((Gp != 0).any(dim=1).sum())
    flops = (2 * cs.P4 * cs.K4 * (n + atoms)
             + float((2 * cs.K4 * c + 2 * cs.K4 + c ** 3 / 3
                      + 2 * c * c).sum()))
    bound = bound_ms(4 * (cs.P4 * n + cs.P4 * cs.K4 + cs.K4 * n), flops,
                     cs.PEAK_F32)

    def k6():
        return fs_cold_fused(D, X, lam=lam, t_unroll=tun,
                             products=gram_inputs(D, X))

    def both():
        pr = gram_inputs(D, X)
        st = fs_cold_fused(D, X, lam=lam, t_unroll=tun, products=pr)
        return fs_scan_seeded(D, X, st, lam=lam, products=pr)

    return {
        "done_on_entry": float(entry.float().mean()),
        "entry_lanes_equal": bool(torch.equal(G[:, entry], Gp[:, entry])),
        "gap_median": float(gap.median()), "gap_max": float(gap.max()),
        "gap_min": float(gap.min()),
        "kkt_median": float(kkt.median()) if kkt.numel() else 0.0,
        "kkt_max": float(kkt.max()) if kkt.numel() else 0.0,
        "done": [float(done.float().mean()), float(donep.float().mean())],
        "done_equal": float((done == donep).float().mean()),
        "overflow_equal": float((ovf == ovfp).float().mean()),
        "iters_max": [int(iters.max()), int(itp.max())],
        "iters_mean": [float(iters.float().mean()),
                       float(itp.float().mean())],
        "k6_ms": cs.cuda_ms(torch, k6),
        "seeded_ms": cs.cuda_ms(
            torch, lambda: fs_scan_seeded(D, X, seed, lam=lam,
                                          products=products)),
        "k6_and_seeded_ms": cs.cuda_ms(torch, both),
        "plain_ms": cs.cuda_ms(
            torch, lambda: fs_scan_seeded_reference(D, X, seed, lam=lam),
            reps=3),
        "bound_ms": bound[0], "bound_by": bound[1],
        "mean_nnz": float(c.mean())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from lyssandra_tpu_torch import _build

    if not torch.cuda.is_available():
        raise SystemExit("fs_seeded_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    log = _build.build(("-Xptxas", "-v"))
    _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s")
    ptxas = cs.ptxas_report(log, r"fs_scan")
    print(f"ptxas: {json.dumps(ptxas)}")
    Dn, Xn = cs.config4_problem()
    lam = cs.LAM
    out = {"card": card, "ptxas": ptxas, "by_case": {}}
    D = torch.from_numpy(Dn).to(dev)
    for tun in (cs.TUN, 4):
        for n in NS:
            X = torch.from_numpy(Xn[:, -n:].copy()).to(dev)
            key = f"data tun={tun} N={n}"
            out["by_case"][key] = case(torch, cs, D, X, lam, tun)
            print(f"{key}: {json.dumps(out['by_case'][key])}")
    D, Xl = learned(torch, dev)
    for n in NS:
        key = f"learned tun={cs.TUN} N={n}"
        out["by_case"][key] = case(torch, cs, D, Xl[:, :n].contiguous(), lam,
                                   cs.TUN)
        print(f"{key}: {json.dumps(out['by_case'][key])}")
    D = torch.from_numpy(Dn).to(dev)
    if args.parent:
        X = torch.from_numpy(Xn[:, :N_FIT].copy()).to(dev)
        out["empty_start"] = parent_case(torch, args.parent, D, X, lam)
        print(f"empty start: {json.dumps(out['empty_start'])}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
