#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lyssandra_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. require a CUDA device; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ and print the build time;
  3. K1 (fixed-T fused OMP) against its plain version: a well-posed
     problem (p=64, K=1024, T=8, N=32768: idx and nsel equal, gamma within
     1e-4) and Gaussian signals (the Batch-OMP benchmark's 262,144 lanes:
     >= 99.9% of lanes pick the same atoms — summation order differs, and
     so do near-ties);
  4. K2 (error-stopped fused OMP) against its plain version on the
     sigma=25 patches of a 512x512 image (eps = 1.15*8*25, T=10): nsel
     equal on >= 99.9% of lanes;
  5. K3 (fused patch pipeline) against its plain version on that image,
     DC removal / + contrast normalization / + whitening: atol 1e-4;
     then the kernels' envelope at small odd shapes (p, K not multiples of
     32; p=512 and T=32, whose shared memory needs the opt-in above 48 KB;
     lanes done on entry; whitening at p=5): the same checks, and a T the
     kernel cannot hold must raise;
  5c. K4/K5 (fused group OMP) against its plain version at the group
     shape p=64, K=1024, gs=4 (256 groups), T=4, N=32768: a well-posed
     group-sparse problem (group ids, nsel, idx equal, gamma within 1e-4),
     Gaussian signals (>= 99.9% of lanes pick the same groups) and lanes
     that freeze on a duplicated group; then its envelope: ragged groups
     (K=62, p=16), gs=8 with T=4 (32 slots), p=512 (shared memory above
     48 KB), T > n_groups through group_omp, and T*gs > 32, which must
     raise;
  5d. K6 (fused feature-sign cold start) against its plain version at
     config 4's width (p=192, K=1024, lam=0.15, Tun=28, N=2048): on a
     well-posed sparse problem done, idx and mask equal on >= 99.9% of
     lanes, theta equal and gact, gr within 1e-4 there; on config 4's
     patches, whose data dictionary holds near-duplicate atoms, the
     kernel must agree with the plain version on as many lanes as the
     plain version agrees with itself in float64 (less 0.1), with the
     same share of lanes done at the handoff (within 0.005); then its
     envelope (p=21, K=100; a coherent pair; lam=1e3, where every lane is
     done on entry and the state is zero; a Tun beyond the kernel, which
     must raise) and its time at N=2048 and N=16384;
  6. the main paths, each counted on its own: (a) Batch-OMP (p=64, K=1024,
     T=8, N=262144) through lyssandra_tpu_torch.batch_omp and the
     sigma=25 denoise of the 512x512 image through Denoiser; (b)
     SparseEncoder("group_omp", T=4, 256 groups of 4) on the 262,144
     Batch-OMP signals, 16 blocks of 16384 = 16 group-kernel launches,
     idx agreeing with the plain version on >= 99.9% of lanes; (c)
     SparseEncoder("bomp", T=8) on the same signals, equal to batch_omp;
     (d) SparseEncoder("lasso", lam=0.15) on config 4's 16,384 patches,
     8 blocks of 2048 = 8 K6 launches, per-lane objectives within rtol
     1e-4, atol 1e-5 (tests/test_lasso.py's) of cold_backend="xla", the
     plain path, on >= 99.9% of lanes and within rtol 1e-3 on all, and
     the KKT conditions of tests/test_lasso.py on every lane;
     every kernel must have launched on one of the paths; the denoised
     image must beat the noisy one by > 3 dB and agree within 0.05 dB with
     a path built from the plain versions;
  7. times (median of 5, CUDA events) of the kernel path and the plain
     path, patches/s and denoise seconds, the group encoder's patches/s,
     the bomp encoder (blocks of 16384) against one batch_omp call, and
     the lasso encoder's patches/s on the kernel path, on
     cold_backend="xla" and on cold_unroll=0 (median of 3), with the host
     syncs of one call;
then one JSON line of per-kernel results and, last, the result line.
Nothing runs on the CPU when there is no GPU.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
P, K, T = 64, 1024, 8               # the Batch-OMP benchmark's shape
GS, T_GROUP = 4, 4                  # the group-OMP shape (256 groups)
BENCH_BLOCK, BENCH_STEPS = 32768, 8  # 262,144 lanes, made as bench.py does
SIGMA, IMG_SIZE = 25.0, 512
REPS = 5
P4, K4, LAM, TUN = 192, 1024, 0.15, 28   # config 4: 8x8x3 patches, K=1024
N4 = 16384                               # config 4's patches, 8 blocks


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def make_problem(rng, p, K, N, T):
    """Unit-norm Gaussian dictionary and signals that are noisy T-sparse
    combinations of its atoms (well-posed greedy recovery)."""
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Gamma = np.zeros((K, N))
    for n in range(N):
        Gamma[rng.choice(K, T, replace=False), n] = rng.standard_normal(T)
    X = D @ Gamma + 0.01 * rng.standard_normal((p, N))
    return D.astype(np.float32), X.astype(np.float32)


def group_problem(rng, p, K, gs, N, n_active):
    """Unit-norm Gaussian dictionary with groups of gs consecutive atoms,
    and signals that are noisy combinations of n_active random groups."""
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    ng = K // gs
    X = 0.01 * rng.standard_normal((p, N))
    for n in range(N):
        for g in rng.choice(ng, n_active, replace=False):
            X[:, n] += D[:, g * gs:(g + 1) * gs] @ rng.standard_normal(gs)
    return D.astype(np.float32), X.astype(np.float32)


def bench_problem():
    """D and the 262,144 Gaussian signals of the Batch-OMP benchmark
    (same shapes, seed and draw order)."""
    rng = np.random.default_rng(0)
    D = rng.standard_normal((P, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    rng.standard_normal((P, 512))   # the benchmark's CPU-oracle sample
    X = np.concatenate([
        rng.standard_normal((P, BENCH_BLOCK)).astype(np.float32)
        for _ in range(BENCH_STEPS)
    ], axis=1)
    return D.astype(np.float32), X


def config4_problem():
    """Config 4's data (benchmarks/ab_fs_activate.py:61-71): 16,384
    unit-norm 8x8 colour patches of four synthetic images, and a
    dictionary of 1,024 of those patches.  The reference draws the
    dictionary with init_dictionary(X, K, "data", 0), whose JAX PRNG
    stream the port cannot reproduce: here numpy's default_rng(0) picks
    1,024 distinct non-zero columns."""
    from lyssandra_tpu_torch.utils.datasets import (
        patch_dataset, synthetic_color_image,
    )

    imgs = [synthetic_color_image(k, 256, seed=s)
            for s, k in enumerate(("texture", "mix", "smooth", "edges"))]
    X = patch_dataset(imgs, p=8, n_patches=N4, seed=1).astype(np.float32)
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-8)
    nonzero = np.where(np.linalg.norm(X, axis=0) > 0.5)[0]
    cols = np.random.default_rng(0).choice(nonzero, K4, replace=False)
    D = X[:, cols].copy()
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    return D, X


def sparse_problem(rng, p, K, N, s):
    """Unit-norm Gaussian dictionary and unit-norm signals that are noisy
    s-sparse combinations of its atoms (a well-posed lasso)."""
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    X = 0.05 * rng.standard_normal((p, N))
    for n in range(N):
        X[:, n] += D[:, rng.choice(K, s, replace=False)] @ \
            rng.standard_normal(s)
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    return D.astype(np.float32), X.astype(np.float32)


def cuda_ms(torch, fn, reps=REPS):
    """Median device time of fn() over `reps` warm runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main():
    import torch

    # a fault inside a kernel can end the process before a block-buffered
    # stdout is flushed: print each line as it comes
    sys.stdout.reconfigure(line_buffering=True)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; it runs only on a GPU")
    sys.path.insert(0, ROOT)
    import lyssandra_tpu_torch as lt
    from lyssandra_tpu_torch import _build
    from lyssandra_tpu_torch.apps.denoise import Denoiser
    from lyssandra_tpu_torch.ops.cuda_fs import (
        fs_cold_fused, fs_cold_fused_reference,
    )
    from lyssandra_tpu_torch.ops.cuda_group import (
        group_omp_fused, group_omp_fused_reference,
    )
    from lyssandra_tpu_torch.ops.cuda_omp import (
        omp_fused, omp_fused_reference,
    )
    from lyssandra_tpu_torch.ops.cuda_patches import (
        fused_patch_pipeline_p1, fused_patch_pipeline_reference,
    )
    from lyssandra_tpu_torch.ops.patches import weighted_reconstruct
    from lyssandra_tpu_torch.solvers.greedy import GreedyResult, _omp_impl
    from lyssandra_tpu_torch.solvers.lasso import host_syncs
    from lyssandra_tpu_torch.utils.datasets import synthetic_image

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # --- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # --- 2. build
    t0 = time.perf_counter()
    log = _build.build(("-Xptxas", "-v"))
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    def dt(a):
        return torch.as_tensor(a, device=dev)

    # --- 3. K1 against its plain version
    D, X = make_problem(np.random.default_rng(0), P, K, 32768, T)
    D, X = dt(D), dt(X)
    got = omp_fused(D, X, T=T)
    want = omp_fused_reference(D, X, T=T)
    check(torch.equal(got[0], want[0]), "K1 idx, well-posed")
    check(torch.equal(got[3], want[3]), "K1 nsel, well-posed")
    k1_err = float((got[1] - want[1]).abs().max())
    check(k1_err <= 1e-4, f"K1 gamma, well-posed: {k1_err}")
    print(f"K1 well-posed N=32768: idx, nsel equal; max |dgamma| {k1_err:.3g}")

    # the freeze rule: atoms 0 and K/2 are both e_0 and lanes 0-7 are 2 e_0,
    # so step 1 leaves r = 0 exactly and step 2 re-picks atom 0 and freezes
    e0 = torch.zeros(P, device=dev)
    e0[0] = 1.0
    Dz = D.clone()
    Dz[:, K // 2:] = Dz[:, :K // 2]
    Dz[:, 0] = Dz[:, K // 2] = e0
    Xz = X[:, :4096].clone()
    Xz[:, :8] = 2.0 * e0[:, None]
    got = omp_fused(Dz, Xz, T=T)
    want = omp_fused_reference(Dz, Xz, T=T)
    check(bool((got[3][:8] == 1).all()) and bool((got[1][:8, 0] == 2).all()),
          "K1 freeze on a repeated atom")
    check(torch.equal(got[3], want[3]), "K1 nsel, duplicated atoms")
    check(bool(torch.isfinite(got[1]).all()), "K1 gamma finite")

    Db, Xb = bench_problem()
    Db, Xb = dt(Db), dt(Xb)
    got = omp_fused(Db, Xb, T=T)
    want = omp_fused_reference(Db, Xb, T=T)
    agree = float((got[0] == want[0]).all(dim=1).float().mean())
    check(agree >= 0.999, f"K1 Gaussian idx agreement {agree}")
    print(f"K1 Gaussian N={Xb.shape[1]}: idx agree on {agree:.6f} of lanes")
    k1_ms = cuda_ms(torch, lambda: omp_fused(Db, Xb, T=T))
    k1_plain_ms = cuda_ms(torch, lambda: omp_fused_reference(Db, Xb, T=T))
    del got, want

    # --- 4. K2 against its plain version, on the denoise patches
    img = synthetic_image("texture", IMG_SIZE, seed=0)
    noisy_np = img + SIGMA * np.random.default_rng(0).standard_normal(
        img.shape)
    img_d = dt(img.astype(np.float32))
    noisy = dt(noisy_np.astype(np.float32))
    Xc, _, _ = fused_patch_pipeline_reference(noisy, 8, do_dc=True)
    eps = 1.15 * 8 * SIGMA
    Dd = lt.dct_dictionary(8, 256, device=dev)
    got = omp_fused(Dd, Xc, T=10, eps=eps, eps_mode=True)
    want = omp_fused_reference(Dd, Xc, T=10, eps=eps, eps_mode=True)
    same = (got[3] == want[3]) & (got[0] == want[0]).all(dim=1)
    agree = float((got[3] == want[3]).float().mean())
    check(agree >= 0.999, f"K2 nsel agreement {agree}")
    k2_err = float((got[1] - want[1]).abs()[same].max())
    print(f"K2 N={Xc.shape[1]}: nsel agree on {agree:.6f} of lanes, mean "
          f"nsel {float(got[3].float().mean()):.3f}; max |dgamma| on "
          f"agreeing lanes {k2_err:.3g}")
    k2_ms = cuda_ms(torch, lambda: omp_fused(
        Dd, Xc, T=10, eps=eps, eps_mode=True))
    k2_plain_ms = cuda_ms(torch, lambda: omp_fused_reference(
        Dd, Xc, T=10, eps=eps, eps_mode=True))
    del got, want

    # --- 5. K3 against its plain version
    Xn, _, _ = fused_patch_pipeline_reference(
        noisy, 8, do_dc=True, do_norm=True)
    Xn64 = Xn.double()
    mu = Xn64.mean(dim=1, keepdim=True)
    lam, V = torch.linalg.eigh((Xn64 - mu) @ (Xn64 - mu).T / Xn.shape[1])
    Wm = (V @ torch.diag(1.0 / torch.sqrt(lam + 1e-2)) @ V.T)
    whiten = (Wm.float(), (Wm @ mu[:, 0]).float())
    k3_err = 0.0
    for kw in ({"do_dc": True}, {"do_dc": True, "do_norm": True},
               {"do_dc": True, "do_norm": True, "whiten": whiten}):
        got = fused_patch_pipeline_p1(noisy, 8, **kw)
        want = fused_patch_pipeline_reference(noisy, 8, **kw)
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        check(max(errs) <= 1e-4, f"K3 {sorted(kw)}: {errs}")
        k3_err = max(k3_err, *errs)
        print(f"K3 {sorted(kw)}: max |d| X, means, scales = {errs}")
    k3_ms = cuda_ms(torch, lambda: fused_patch_pipeline_p1(noisy, 8))
    k3_plain_ms = cuda_ms(
        torch, lambda: fused_patch_pipeline_reference(noisy, 8))
    del got, want, Xn, Xn64

    # --- 5b. the kernels' envelope at small odd shapes
    def omp_case(p, K, N, sparsity, T, eps=None, scale=()):
        D, X = make_problem(np.random.default_rng(p + K + N), p, K, N,
                            sparsity)
        for cols, f in scale:
            X[:, cols] *= f
        D, X = dt(D), dt(X)
        kw = {"T": T} if eps is None else {"T": T, "eps": eps,
                                           "eps_mode": True}
        got = omp_fused(D, X, **kw)
        want = omp_fused_reference(D, X, **kw)
        keep = (torch.arange(T, device=dev)[None, :]
                < want[3][:, None]).int()
        what = f"envelope p={p} K={K} N={N} T={T} eps={eps}"
        check(torch.equal(got[3], want[3]), f"{what}: nsel")
        check(torch.equal(got[0] * keep, want[0] * keep), f"{what}: idx")
        err = float((got[1] - want[1]).abs().max())
        check(err <= 1e-4, f"{what}: gamma {err}")
        print(f"{what}: nsel, idx equal; max |dgamma| {err:.3g}; mean nsel "
              f"{float(got[3].float().mean()):.2f}")
        return D, X

    omp_case(12, 100, 1000, 3, 4)
    omp_case(16, 128, 333, 3, 6, eps=0.3,
             scale=((slice(0, 100), 1e-6), (slice(100, 200), 0.05)))
    D512, X512 = omp_case(512, 1024, 2048, 8, 8)
    omp_case(64, 1024, 999, 8, 32, eps=0.12)
    try:
        omp_fused(D512, X512, T=200)
        check(False, "a T beyond the kernel's shared memory did not raise")
    except ValueError as e:
        print(f"T=200 at p=512 raises: {e}")
    del D512, X512

    rng = np.random.default_rng(1)
    odd = dt((255.0 * rng.random((33, 47))).astype(np.float32))
    Wm5 = dt(rng.standard_normal((25, 25)).astype(np.float32))
    off5 = dt(rng.standard_normal(25).astype(np.float32))
    for p, kw in ((8, {"do_dc": True, "do_norm": True}),
                  (5, {"do_dc": True, "do_norm": True,
                       "whiten": (Wm5, off5)})):
        got = fused_patch_pipeline_p1(odd, p, **kw)
        want = fused_patch_pipeline_reference(odd, p, **kw)
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        check(max(errs) <= 1e-4, f"K3 33x47 p={p} {sorted(kw)}: {errs}")
        print(f"K3 33x47 p={p} {sorted(kw)}: max |d| = {errs}")

    # --- 5c. K4/K5 against its plain version, then its envelope
    def group_case(D, X, groups, T_, what, agree_min=1.0):
        got = group_omp_fused(D, X, groups, T_)
        want = group_omp_fused_reference(D, X, groups, T_)
        same = (got[4] == want[4]).all(dim=1)
        agree = float(same.float().mean())
        check(agree >= agree_min, f"{what}: group ids agree on {agree}")
        check(torch.equal(got[3], want[3]) if agree_min == 1.0
              else float((got[3] == want[3]).float().mean()) >= agree_min,
              f"{what}: nsel")
        check(torch.equal(got[0][same], want[0][same]), f"{what}: idx")
        check(bool(torch.isfinite(got[1]).all()), f"{what}: gamma finite")
        err = float((got[1] - want[1]).abs()[same].max())
        check(err <= 1e-4, f"{what}: gamma {err}")
        print(f"{what}: group ids agree on {agree:.6f} of lanes; max "
              f"|dgamma| there {err:.3g}; mean nsel "
              f"{float(got[3].float().mean()):.3f}")
        return got, err

    groups = np.repeat(np.arange(K // GS), GS)
    Dg, Xg = group_problem(np.random.default_rng(2), P, K, GS, 32768,
                           T_GROUP)
    Dg, Xg = dt(Dg), dt(Xg)
    _, k4_err = group_case(Dg, Xg, groups, T_GROUP,
                           "K4 well-posed p=64 K=1024 gs=4 T=4 N=32768")
    Xk4 = Xb[:, :32768].contiguous()
    group_case(Db, Xk4, groups, T_GROUP, "K4 Gaussian N=32768",
               agree_min=0.999)
    # the freeze rule: group 1 repeats group 0's atoms e_0..e_3 and lanes
    # 0-7 are 2 e_0, so step 1 leaves r = 0 and step 2's block is singular
    Dz = Db.clone()
    Dz[:, 0:4] = Dz[:, 4:8] = torch.eye(P, device=dev)[:, :4]
    Xz = Xk4[:, :4096].clone()
    Xz[:, :8] = 2.0 * torch.eye(P, device=dev)[:, :1]
    got, _ = group_case(Dz, Xz, groups, T_GROUP, "K4 duplicated group")
    check(bool((got[3][:8] == 1).all()) and bool((got[1][:8, 0] == 2).all()),
          "K4 freeze on a duplicated group")
    k4_ms = cuda_ms(torch, lambda: group_omp_fused(Db, Xk4, groups, T_GROUP))
    k4_plain_ms = cuda_ms(torch, lambda: group_omp_fused_reference(
        Db, Xk4, groups, T_GROUP))
    print(f"K4 p=64 K=1024 gs=4 T=4 N=32768: kernel {k4_ms:.3f} ms, plain "
          f"{k4_plain_ms:.3f} ms")

    rng = np.random.default_rng(3)
    Dr = rng.standard_normal((16, 62))
    Dr /= np.linalg.norm(Dr, axis=0, keepdims=True)
    Xr = rng.standard_normal((16, 1000))
    group_case(dt(Dr.astype(np.float32)), dt(Xr.astype(np.float32)),
               np.minimum(np.arange(62) // 4, 14), 3,
               "envelope ragged groups K=62 p=16 (gs=6) T=3", agree_min=0.999)
    D8, X8 = group_problem(rng, P, K, 8, 2048, 4)
    group_case(dt(D8), dt(X8), np.repeat(np.arange(K // 8), 8), 4,
               "envelope gs=8 T=4 (32 slots)")
    D5, X5 = group_problem(rng, 512, K, GS, 1024, 4)
    D5, X5 = dt(D5), dt(X5)
    group_case(D5, X5, groups, 4, "envelope p=512 gs=4 T=4")
    Dt8, Xt8 = group_problem(rng, P, 32, GS, 1024, 2)
    Dt8, Xt8 = dt(Dt8), dt(Xt8)
    g8 = np.repeat(np.arange(8), GS)
    before = lt.launch_counts()["group_omp_fused"]
    res8 = lt.group_omp(Dt8, Xt8, g8, 10, dense=False)    # T_eff = 8
    check(lt.launch_counts()["group_omp_fused"] == before + 1,
          "group_omp T > n_groups did not take the kernel")
    want8 = group_omp_fused_reference(Dt8, Xt8, g8, 8)
    agree = float((res8.idx == want8[0]).all(dim=1).float().mean())
    check(tuple(res8.idx.shape) == (1024, 32) and agree >= 0.999,
          f"T > n_groups: idx agree on {agree}")
    check(bool((res8.nsel == want8[3] * GS).float().mean() >= 0.999),
          "T > n_groups: nsel")
    print(f"envelope T=10 > 8 groups through group_omp: idx agree on "
          f"{agree:.6f} of lanes, mean nsel {float(res8.nsel.float().mean())}")
    try:
        group_omp_fused(D5, X5, groups, 9)
        check(False, "T*gs = 36 > 32 slots did not raise")
    except ValueError as e:
        print(f"T*gs=36 raises: {e}")
    del D5, X5, Dz, Xz

    # --- 5d. K6 against its plain version, then its envelope
    def fs_agree(a, b):
        same = ((a[5] == b[5]) & (a[0] == b[0]).all(dim=1)
                & (a[1] == b[1]).all(dim=1))
        return float(same.float().mean()), same

    def fs_case(D, X, lam, tun, what, agree_min=0.999):
        got = fs_cold_fused(D, X, lam=lam, t_unroll=tun)
        want = fs_cold_fused_reference(D, X, lam=lam, t_unroll=tun)
        agree, same = fs_agree(got, want)
        check(agree >= agree_min, f"{what}: done/idx/mask agree on {agree}")
        check(torch.equal(got[2][same], want[2][same]), f"{what}: theta")
        err = max(float((a - b).abs()[same].max()) if bool(same.any())
                  else 0.0 for a, b in zip(got[3:5], want[3:5]))
        check(err <= 1e-4, f"{what}: gact, gr {err}")
        print(f"{what}: done/idx/mask agree on {agree:.6f} of lanes, theta "
              f"equal, max |d| gact, gr there {err:.3g}; done "
              f"{float(got[5].float().mean()):.4f}")
        return got, err

    Dw, Xw = sparse_problem(np.random.default_rng(4), P4, K4, 2048, 4)
    Dw, Xw = dt(Dw), dt(Xw)
    _, k6_err = fs_case(Dw, Xw, LAM, TUN,
                        "K6 well-posed p=192 K=1024 Tun=28 N=2048")
    Dc4, Xc4 = config4_problem()
    Dc4, Xc4 = dt(Dc4), dt(Xc4)
    Xb4 = Xc4[:, :2048]
    got = fs_cold_fused(Dc4, Xb4, lam=LAM, t_unroll=TUN)
    want = fs_cold_fused_reference(Dc4, Xb4, lam=LAM, t_unroll=TUN)
    want64 = fs_cold_fused_reference(Dc4.double(), Xb4.double(), lam=LAM,
                                     t_unroll=TUN)
    agree, _ = fs_agree(got, want)
    agree64, _ = fs_agree(want64, want)
    done_k = float(got[5].float().mean())
    done_p = float(want[5].float().mean())
    print(f"K6 config 4 N=2048: done/idx/mask agree with the plain version on "
          f"{agree:.6f} of lanes (plain in float64 against float32: "
          f"{agree64:.6f}); done at the handoff: kernel {done_k:.6f}, plain "
          f"{done_p:.6f}")
    check(agree >= agree64 - 0.1, "K6 config 4 agreement")
    check(abs(done_k - done_p) <= 0.005, "K6 config 4 done share")
    del got, want, want64

    rng = np.random.default_rng(5)
    Du = rng.standard_normal((21, 100))
    Du /= np.linalg.norm(Du, axis=0)
    Xu = rng.standard_normal((21, 500))
    Xu /= np.linalg.norm(Xu, axis=0)
    fs_case(dt(Du.astype(np.float32)), dt(Xu.astype(np.float32)), 0.1, 6,
            "envelope p=21 K=100 Tun=6")
    Dp = rng.standard_normal((24, 96))
    Dp[:, 50] = Dp[:, 10] + 0.01 * rng.standard_normal(24)   # coherent pair
    Dp /= np.linalg.norm(Dp, axis=0)
    Xp = np.zeros((24, 512))
    for _ in range(3):
        Xp += Dp[:, rng.integers(0, 96, 512)] * rng.standard_normal(512)
    Xp += 0.05 * rng.standard_normal((24, 512))
    Xp /= np.linalg.norm(Xp, axis=0)
    fs_case(dt(Dp.astype(np.float32)), dt(Xp.astype(np.float32)), LAM, 6,
            "envelope coherent pair p=24 K=96 Tun=6")
    got, _ = fs_case(Dc4, Xb4, 1e3, TUN, "envelope lam=1e3", agree_min=1.0)
    check(bool(got[5].all()) and not bool(got[1].any())
          and not bool(got[3].any()) and not bool(got[0].any()),
          "lam=1e3: every lane done on entry with a zero state")
    try:
        fs_cold_fused(Dc4, Xb4, lam=LAM, t_unroll=33)
        check(False, "a Tun beyond the kernel did not raise")
    except ValueError as e:
        print(f"Tun=33 raises: {e}")
    k6_ms = cuda_ms(torch, lambda: fs_cold_fused(Dc4, Xb4, lam=LAM,
                                                 t_unroll=TUN))
    k6_plain_ms = cuda_ms(torch, lambda: fs_cold_fused_reference(
        Dc4, Xb4, lam=LAM, t_unroll=TUN))
    k6_ms_all = cuda_ms(torch, lambda: fs_cold_fused(Dc4, Xc4, lam=LAM,
                                                     t_unroll=TUN))
    k6_plain_ms_all = cuda_ms(torch, lambda: fs_cold_fused_reference(
        Dc4, Xc4, lam=LAM, t_unroll=TUN))
    print(f"K6 p={P4} K={K4} Tun={TUN}: N=2048 kernel {k6_ms:.3f} ms, plain "
          f"{k6_plain_ms:.3f} ms; N={N4} kernel {k6_ms_all:.3f} ms, plain "
          f"{k6_plain_ms_all:.3f} ms")

    # --- 6. the main paths, each counted on its own
    cfg = lt.DenoiseConfig(sigma=SIGMA)
    denoiser = Denoiser(Dd, cfg)
    lt.reset_launch_counts()
    res = lt.batch_omp(Db, Xb, T=T, dense=False)
    out = denoiser(noisy)
    torch.cuda.synchronize()
    launches = lt.launch_counts()
    print(f"path (a) batch_omp + denoise launches: {launches}")

    group_enc = lt.SparseEncoder("group_omp", {"T": T_GROUP,
                                               "groups": groups})
    lt.reset_launch_counts()
    gres = group_enc.encode(Xb, Db, dense=False)
    torch.cuda.synchronize()
    launches_g = lt.launch_counts()
    print(f"path (b) SparseEncoder('group_omp') launches: {launches_g}")
    n_blocks = Xb.shape[1] // group_enc.block
    check(launches_g["group_omp_fused"] == n_blocks,
          f"group encoder launched the group kernel "
          f"{launches_g['group_omp_fused']} times, not {n_blocks}")
    gwant = group_omp_fused_reference(Db, Xb, groups, T_GROUP)
    check(tuple(gres.idx.shape) == (Xb.shape[1], T_GROUP * GS),
          "group encoder idx shape")
    check(bool(torch.isfinite(gres.gamma).all()), "group encoder finite")
    agree = float((gres.idx == gwant[0]).all(dim=1).float().mean())
    check(agree >= 0.999, f"group encoder idx agreement {agree}")
    print(f"group encoder N={Xb.shape[1]}: idx agree with the plain version "
          f"on {agree:.6f} of lanes")
    del gwant

    bomp_enc = lt.SparseEncoder("bomp", {"T": T})
    lt.reset_launch_counts()
    bres = bomp_enc.encode(Xb, Db, dense=False)
    torch.cuda.synchronize()
    launches_b = lt.launch_counts()
    print(f"path (c) SparseEncoder('bomp') launches: {launches_b}")
    check(launches_b["omp_fused_t"] == Xb.shape[1] // bomp_enc.block,
          "bomp encoder launches")
    for a, b in zip(bres, res):
        check(torch.equal(a, b), "bomp encoder differs from batch_omp")
    print("bomp encoder equals batch_omp on all lanes")

    lasso_enc = lt.SparseEncoder("lasso", {"lam": LAM})
    lt.reset_launch_counts()
    syncs0 = host_syncs()
    G4 = lasso_enc.encode(Xc4, Dc4)
    torch.cuda.synchronize()
    launches_d = lt.launch_counts()
    syncs_d = host_syncs() - syncs0
    print(f"path (d) SparseEncoder('lasso') launches: {launches_d}; host "
          f"syncs {syncs_d}")
    n_blocks = N4 // lasso_enc.block
    check(launches_d["fs_cold"] == n_blocks,
          f"lasso encoder launched K6 {launches_d['fs_cold']} times, not "
          f"{n_blocks}")
    check(tuple(G4.shape) == (K4, N4) and bool(torch.isfinite(G4).all()),
          "lasso encoder codes: shape, finite")
    G4x = lt.SparseEncoder("lasso", {"lam": LAM, "cold_backend": "xla"}
                           ).encode(Xc4, Dc4)

    def lasso_objective(G):
        R = Xc4.double() - Dc4.double() @ G.double()
        return (R * R).sum(dim=0) + LAM * G.double().abs().sum(dim=0)

    # Both paths stop at points whose KKT residuals are within the done
    # tolerances (1e-4 on active stationarity); on the near-singular
    # active sets of config 4's data dictionary such points may differ in
    # objective by a few 1e-5.  So: tests/test_lasso.py's tolerance (rtol
    # 1e-4, atol 1e-5) on >= 99.9% of lanes, rtol 1e-3 on every lane.
    o_k, o_x = lasso_objective(G4), lasso_objective(G4x)
    gap = (o_k - o_x).abs()
    n_out = int((gap > 1e-5 + 1e-4 * o_x.abs()).sum())
    check(n_out <= N4 // 1000 and bool((gap <= 1e-3 * o_x.abs()).all()),
          f"lasso objective against the plain path: {n_out} lanes beyond "
          f"rtol 1e-4, max gap {float(gap.max())}")
    Gd = G4.double()
    grad = 2.0 * (Dc4.double().T @ (Dc4.double() @ Gd - Xc4.double()))
    act = Gd.abs() > 1e-10
    viol_act = float((grad + LAM * torch.sign(Gd)).abs()[act].max())
    viol_inact = float(grad.abs()[~act].max())
    check(viol_act < 1e-3 and viol_inact <= LAM + 1e-3,
          f"lasso KKT: active {viol_act}, inactive {viol_inact}")
    print(f"lasso encoder N={N4}: objective mean {float(o_k.mean()):.6f}, "
          f"max |gap| to the plain path {float(gap.max()):.3g} (max relative "
          f"{float((gap / o_x.clamp_min(1e-12)).max()):.3g}; {n_out} lanes "
          f"beyond rtol 1e-4, atol 1e-5); KKT active {viol_act:.3g}, "
          f"inactive max {viol_inact:.6f} (lam {LAM}); mean nnz "
          f"{float(act.sum(dim=0).double().mean()):.3f}")
    del G4x, Gd, grad

    for name in launches:
        total = (launches[name] + launches_g[name] + launches_b[name]
                 + launches_d[name])
        check(total > 0, f"kernel {name} not launched on any main path")

    ref = omp_fused_reference(Db, Xb, T=T)
    check(tuple(res.idx.shape) == (Xb.shape[1], T), "batch_omp idx shape")
    check(bool(torch.isfinite(res.gamma).all()), "batch_omp gamma finite")
    agree = float((res.idx == ref[0]).all(dim=1).float().mean())
    check(agree >= 0.999, f"batch_omp idx agreement {agree}")
    del ref

    def plain_denoise():
        """The same forward from the plain versions only."""
        T1 = min(10, cfg.T_max)
        Xc, means, _ = fused_patch_pipeline_reference(noisy, 8, do_dc=True)
        r = GreedyResult(*omp_fused_reference(
            Dd, Xc, T=T1, eps=eps, eps_mode=True))
        Gamma = r.dense(Dd.shape[1])
        bad = torch.nonzero((r.nsel == T1) & (r.err > eps * eps))[:, 0]
        if len(bad):
            Gamma[:, bad] = _omp_impl(Dd, Xc[:, bad], eps, T=cfg.T_max,
                                      eps_mode=True).dense(Dd.shape[1])
        Xhat = Dd @ Gamma + means[None, :]
        return weighted_reconstruct(Xhat, noisy, 8, cfg.lam / SIGMA)

    out_plain = plain_denoise()
    check(tuple(out.shape) == (IMG_SIZE, IMG_SIZE), "denoise shape")
    check(bool(torch.isfinite(out).all()), "denoise output finite")
    p_noisy = lt.psnr(noisy, img_d)
    p_out = lt.psnr(out, img_d)
    p_plain = lt.psnr(out_plain, img_d)
    print(f"denoise {IMG_SIZE}^2 sigma={SIGMA}: PSNR noisy {p_noisy:.4f} dB,"
          f" kernel path {p_out:.4f} dB, plain path {p_plain:.4f} dB")
    check(p_out > p_noisy + 3.0, "denoise gains less than 3 dB")
    check(abs(p_out - p_plain) <= 0.05, "kernel and plain denoise differ")

    # --- 7. times
    N = Xb.shape[1]
    bomp_ms = cuda_ms(torch, lambda: lt.batch_omp(Db, Xb, T=T, dense=False))
    bomp_plain_ms = cuda_ms(torch, lambda: omp_fused_reference(Db, Xb, T=T))
    print(f"batch_omp p={P} K={K} T={T} N={N}: kernel path "
          f"{bomp_ms:.3f} ms = {N / bomp_ms * 1e3:.1f} patches/s; plain "
          f"{bomp_plain_ms:.3f} ms = {N / bomp_plain_ms * 1e3:.1f} patches/s")
    genc_ms = cuda_ms(torch, lambda: group_enc.encode(Xb, Db, dense=False))
    gone_ms = cuda_ms(torch, lambda: lt.group_omp(Db, Xb, groups, T_GROUP,
                                                  dense=False))
    print(f"group encoder (blocks of {group_enc.block}) p={P} K={K} gs={GS} "
          f"T={T_GROUP} N={N}: {genc_ms:.3f} ms = "
          f"{N / genc_ms * 1e3:.1f} patches/s; one group_omp call "
          f"{gone_ms:.3f} ms = {N / gone_ms * 1e3:.1f} patches/s")
    benc_ms = cuda_ms(torch, lambda: bomp_enc.encode(Xb, Db, dense=False))
    print(f"bomp encoder (blocks of {bomp_enc.block}) N={N}: "
          f"{benc_ms:.3f} ms = {N / benc_ms * 1e3:.1f} patches/s; one "
          f"batch_omp call {N / bomp_ms * 1e3:.1f} patches/s")
    for what, params in (("kernel path", {}),
                         ("cold_backend='xla'", {"cold_backend": "xla"}),
                         ("cold_unroll=0", {"cold_unroll": 0})):
        enc = lt.SparseEncoder("lasso", {"lam": LAM, **params})
        syncs0 = host_syncs()
        enc.encode(Xc4, Dc4)
        syncs = host_syncs() - syncs0
        ms = cuda_ms(torch, lambda: enc.encode(Xc4, Dc4), reps=3)
        print(f"lasso encoder {what} p={P4} K={K4} N={N4}: {ms:.3f} ms = "
              f"{N4 / ms * 1e3:.1f} patches/s; host syncs per call {syncs}")
    den_ms = cuda_ms(torch, lambda: denoiser(noisy))
    den_plain_ms = cuda_ms(torch, plain_denoise)
    print(f"denoise {IMG_SIZE}^2: kernel path {den_ms / 1e3:.4f} s, plain "
          f"path {den_plain_ms / 1e3:.4f} s")

    kernels = [
        {"name": "omp_fused (fixed T)", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/omp_fused.cu",
         "replaces": "lyssandra_tpu/ops/pallas_omp.py:79",
         "launches": launches["omp_fused_t"] + launches_b["omp_fused_t"],
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "omp_fused (eps exit)", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/omp_fused.cu",
         "replaces": "lyssandra_tpu/ops/pallas_omp.py:235",
         "launches": launches["omp_fused_eps"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "fused_patches", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/fused_patches.cu",
         "replaces": "lyssandra_tpu/ops/pallas_patches.py:37",
         "launches": launches["fused_patches"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "group_omp_fused", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/group_omp.cu",
         "replaces": "lyssandra_tpu/ops/pallas_group.py:52,253",
         "launches": launches_g["group_omp_fused"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms},
        {"name": "fs_cold", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/fs_cold.cu",
         "replaces": "lyssandra_tpu/ops/pallas_fs.py:53",
         "launches": launches_d["fs_cold"], "max_abs_err": k6_err,
         "ms": k6_ms, "plain_ms": k6_plain_ms},
    ]
    for k in kernels:
        check(all(math.isfinite(k[f]) for f in ("max_abs_err", "ms",
                                                 "plain_ms")),
              f"non-finite measurement for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
