#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lyssandra_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. require a CUDA device; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ and print the build time and
     ptxas's registers, shared memory and spills;
  3. K1 (fixed-T fused OMP, in the Gram form) against its plain version,
     the residual form: a well-posed problem (p=64, K=1024, T=8, N=32768:
     idx and nsel equal, gamma within 1e-4), lanes that freeze on a
     repeated atom, and Gaussian signals (the Batch-OMP benchmark's
     262,144 lanes: >= 99.9% of lanes pick the same atoms — the two forms
     round differently, and near-ties follow rounding); its time, the
     share of it that the G = D^T D product takes, its time at T=1 (the
     alpha0 product without Gram rows), the lanes a block carries and the
     kernel's shared memory against the wrapper's formula;
  4. K2 (error-stopped fused OMP) against its plain version on the
     sigma=25 patches of a 512x512 image (eps = 1.15*8*25, T=10): nsel
     equal on >= 99.9% of lanes; its time and lanes a block;
  5. K3 (fused patch pipeline) against its plain version on that image,
     DC removal / + contrast normalization / + whitening at p=8, and at
     p=7 (the generic path) DC removal / + whitening: atol 1e-4; each
     timed one call at a time and in a CUDA graph (the device time), beside
     its bound; then the kernels' envelope at small odd shapes (p, K not
     multiples of 32; p=512 and T=32, whose shared memory needs the opt-in
     above 48 KB; lanes done on entry; whitening at p=5): the same checks,
     and a T the kernel cannot hold must raise; K3 also on a flat image
     (scales clamp to eps), on patch rows one past the kernel's runs of 256
     and 64 patches, and at p=150, whose image tile does not fit shared
     memory;
  5g. the product kernel C = A^T B (csrc/gram.cu, which G = D^T D of
     K1/K2 and alpha0 = X^T D and G of the Gram-form K4 and K6 come from;
     run before 5c and 5d) against A.T @ B at K4's shapes (p=64: alpha0
     of a 16,384- and a 32,768-lane block over K=1024; Gp, which is also
     K1's G, symmetric), K6's (p=192: alpha0 of a 2,048-lane block; G,
     symmetric) and ragged edges (p=21, M=500, K=100; p=512, M=1000,
     K=130; p=576, M=2048, K=1024, K6's alpha0 for 24x24 patches; p=1;
     symmetric at p=13, K=67 and p=576, K=1024): every entry within twice
     the float32 dot-product bound, 2 gamma_p ||a_i|| ||b_j||, and the
     symmetric form equal to the full product; its time at the main-path
     shapes against torch.mm(A.t(), B), one call each and in a CUDA graph
     (the device time without the host's launch overhead);
  5c. K4/K5 (fused group OMP) against its plain version at the group
     shape p=64, K=1024, gs=4 (256 groups), T=4, N=32768: a well-posed
     group-sparse problem (group ids, nsel, idx equal, gamma within 1e-4),
     Gaussian signals (>= 99.9% of lanes pick the same groups) and lanes
     that freeze on a duplicated group; its time and its wrapper's parts
     (slot dictionary, both products, atom ids); then its envelope: ragged groups
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
     envelope (p=21, K=100; a coherent pair; p=576, K=1024, Tun=28 through
     the solver's gate; lam=1e3, where every lane is
     done on entry and the state is zero; a Tun beyond the kernel, which
     must raise) and its time at N=2048 and N=16384 (K4's and K6's times
     are the wrappers', product launches included), and the steps its
     lanes run (for its bound);
  5d2. the feature-sign search kernel (csrc/fs_scan.cu, the online fit's
     in-loop coder from the empty active set) against its plain version
     (_fs_init + _fs_loop) at config 4's width (lam=0.15) on config 4's
     patches at N=1024 and 4096, on the well-posed problem of 5d and on
     its envelope problems (p=21, K=100; the coherent pair): per lane the
     objective gap over the plain version's codes (median at most 1e-8,
     max 2e-3), the KKT breach of the lanes done without overflow (median
     at most 5e-5), done and overflow equal on >= 99% of lanes; lanes
     done on entry (lam=1e3: zero codes), cut by max_iter=3, overflowing
     at max_active=4; the envelope (the kernel's shared memory a lane
     against the wrapper's formula; max_active=65 raises; the solver's
     gate takes config 4's call and refuses n_activate=2, warm_start=4,
     cold_unroll=28); its time (the wrapper's, two product launches
     included) one call at a time and in a CUDA graph beside the plain
     version's and its bound;
  5e. K7 (fused selection) against its plain version at p=64, K=1024 on
     the 262,144 Gaussian lanes, f32 and bf16: picks equal on >= 99.9% of
     lanes; exact ties (atom 7 = atom 3, and atom 128 = atom 127 across two
     atom tiles) give the lower index on every lane; its envelope (p=5
     with K=100, p=512, N=4099 and N=333; shapes that straddle its tiles:
     N=130 with p=5, K=129 and p=17, K=257; p=256 and 257, where the f32
     tile changes; K=1,345 at p=64 and K=2,000 at p=48, where bf16 streams
     D instead of holding it; f32 and bf16), the kernel's shared memory
     against cuda_select's formula at each tile choice, and p=513, which
     must raise; the machine code (cuobjdump -sass): HMMA in both bf16
     kernels, FFMA and no HMMA in the float32 ones;
     the times of the kernel (one call, and in a CUDA graph), its plain
     version and the library pairs argmax(|r @ D|), in float32 and with
     bf16 operands (whose product is rounded to bf16, so a yardstick of
     speed, not the same function);
  6. the main paths, each counted on its own: (a) Batch-OMP (p=64, K=1024,
     T=8, N=262144) through lyssandra_tpu_torch.batch_omp and the
     sigma=25 denoise of the 512x512 image through Denoiser (one K1, one
     K2 and their two G products); (b)
     SparseEncoder("group_omp", T=4, 256 groups of 4) on the 262,144
     Batch-OMP signals, 16 blocks of 16384 = 16 group-kernel launches and
     32 product launches (alpha0 and Gp per block), idx agreeing with the
     plain version on >= 99.9% of lanes; (c)
     SparseEncoder("bomp", T=8) on the same signals, 16 blocks = 16 K1 and
     16 product launches, equal to batch_omp;
     (d) SparseEncoder("lasso", lam=0.15) on config 4's 16,384 patches,
     8 blocks of 2048 = 8 K6 launches and 16 product launches, per-lane
     objectives within rtol 1e-4, atol 1e-5 (tests/test_lasso.py's) of
     cold_backend="xla", the plain path, on >= 99.9% of lanes and within rtol 1e-3 on all, and
     the KKT conditions of tests/test_lasso.py on every lane; (e)
     greedy._omp_impl(fused_select=True) on the 262,144 Batch-OMP signals
     (8 K7 launches), idx agreeing with fused_select=False on >= 99.9% of
     lanes and exactly (gamma within 1e-4) on phase 3's well-posed
     problem, then corr_dtype="bf16" and eps mode on the denoise patches
     (at most T launches); (f) SparseEncoder("nn_omp", T=8) on the solver
     sweep's 131,072 signals made non-negative: codes >= 0, and the scan
     and unrolled forms agree on one block by tests/test_greedy.py's rule;
     (g) inpaint of the 512x512 image with 25% of the pixels missing: the
     error on the missing pixels below a quarter of the corrupted image's,
     the known pixels kept within 1e-4; (h) SparseEncoder("llc", knn=5)
     on the same signals: codes sum to 1 within 1e-5, the support is the 5
     largest d.x, 1,024 lanes within 1e-4 of a float64 solve;
     the denoised image must beat the noisy one by > 3 dB and agree
     within 0.05 dB with a path built from the plain versions;
  7. a p=768 colour denoise (16 x 16 x 3 patches of a 64x64 image, K=256)
     through the route the denoiser's gate picks (K2 where the kernel
     takes the shape, else blocked Batch-OMP; its launches must say
     which), PSNR within 0.05 dB of the same denoise on the CPU; then
     times (median of 5, CUDA events) of the kernel path and the plain
     path, patches/s and denoise seconds, the group encoder's patches/s,
     the bomp encoder (blocks of 16384) against one batch_omp call, and
     the lasso encoder's patches/s on the kernel path, on
     cold_backend="xla" and on cold_unroll=0 (median of 3), with the host
     syncs of one call; _omp_impl with fused_select True and False (f32
     and bf16), the nn_omp and llc encoders' patches/s and the inpaint
     seconds;
  8. the dictionary-learning paths, after the times above so that these
     read as before them: (i) KSVDLearner at config 2's full width (50,000
     8x8 patches of the 512^2 barbara and lena stand-ins, K=512, T=8, 20
     iterations, after a one-iteration warm-up): 4 K1 and 4 product
     launches and one K10 (the B=1 atom sweep) an iteration, the sweep
     phase monotone on every iteration
     (objective <= 1.001 x the post-coding one), no rise above 3% between
     iterations, net progress, unit-norm atoms, the reference's history
     keys, the host syncs of the fit (torch's sync debug mode, checked on
     two scalar reads first); init_dictionary on the GPU equal to the
     CPU's; one coding block (16,384 patches) through K1 against its plain
     version lane by lane, from D0 and from the learned D: gamma within
     1e-4 of ||x|| and err within 1e-6 of ||x||^2 where the picks agree;
     where they part, the same residual energy within 1e-3 of ||x||^2;
     picks equal to a float64 solve's on as many lanes as the plain
     float32 residual and Gram forms manage (less 0.5% of the lanes: D0's
     near-duplicate atoms tie within rounding), and from the learned D
     equal to the plain version's on >= 99.9% of lanes; the first 3
     iterations again, each coded also by the plain Gram form and the
     plain residual form from the same D (no K1 launch): post-coding
     objectives within 1e-5 and 1e-4, post-sweep objectives within 1%,
     timed by parts (coding, sweep, stats and replacement) with CUDA
     events; K10 from the learned D and its K1 codes against the dense
     sweep in float64 (atom distances within 1e-4 largest, 1e-6 median),
     two launches bit for bit, one sweep timed (CUDA events, median of 5
     warm calls), under 10 ms, beside its plain version (the dense sweep,
     eager) and the dense sweep replayed from its CUDA graph; (j) compact codes, 3
     iterations at atom_block=8, objective within 5% of dense codes at
     atom_block=8, peak device memory of both routes; (k) denoise_adaptive
     of the 512^2 image at sigma=25 (K=256, 12 iterations on 30,000
     patches, T_max=16): K2 launches in the training and in the denoise,
     one K3; one training block (16,384 patches, T=16) through K2 against
     its plain version with the learned D (nsel and picks equal on >= 99.9%
     of lanes, gamma within 1e-5 of ||x|| there); PSNR above the noisy image's + 3 dB, at least the DCT
     denoise's - 0.1 dB, and within 0.05 dB of the same denoise from the
     plain versions with the learned D;
  9. online dictionary learning and the classifiers, after phase 8: (l)
     OnlineDictionaryLearner.fit at config 4's full width (100,000 unit-norm
     8x8x3 patches of the four synthetic colour images and 2,048 held out,
     K=1024, lam=0.15, batch 4,096, chunks of 8, code_blocks=4; one
     warm-up chunk, its host syncs counted in torch's sync debug mode,
     then the timed epoch of 24 minibatches, ODL_CHUNKS chunks): one
     fs_scan and two product launches a coding block (its in-loop coder
     is the search kernel) and one online_sweep launch a minibatch (K9,
     the atom sweep), the reference's history
     keys, the holdout objective falling, atoms in the unit ball; one more
     minibatch through _online_chunk from the learned state: A and B grow
     by Gamma Gamma^T and X Gamma^T (float64, 1e-4 of their norms), the
     in-loop codes meet tests/test_lasso.py's KKT conditions and come within
     rtol 1e-3 of feature_sign's plain path (cold_backend="xla",
     cold_unroll=0) per lane; times by parts (coding, statistics, atom
     sweep, holdout) with CUDA events, and the coding's host syncs from
     the learned D (the solver's counter); K9 from the learned state
     against the float64 sweep (atom distances within 1e-5 largest, 1e-6
     median) and one sweep timed (CUDA events, median of 5 warm calls) at
     clusters of 4, 8 and 16 CTAs and at the one it picks, under 5 ms,
     beside the plain loop; (m) partial_fit on three minibatches
     of a stream from a data D0: one K6, two product and one sweep
     launches a minibatch, K6 on the first held to the plain version's own
     float32/float64 agreement (less 0.1) as in 5d, fit over the same
     minibatches from the same state within 1% in holdout objective; (n)
     config 5 on digits-like data made here (digits_problem: 1,257 training
     and 540 test images in 10 classes): LC-KSVD (K=500, T=8, 20
     iterations) fit with its parts, 21 K1 and 21 product launches, unit
     atoms, A_ and W_ shapes; SRC (T=10) predict, one K1 launch; K1 lane
     by lane against its plain version in float32 and float64, as in (i),
     on SRC's coding (K=1,257) and on LC-KSVD's stacked coding (p=574,
     K=500, T=8) from the learned stacked dictionary: picks equal to the
     float64 solve's on as many lanes as the plain version's (less 0.5%),
     gamma within 1e-4 of ||x|| and err within 1e-6 of ||x||^2 where the
     picks agree; both accuracies above 0.8 and within 0.02 of the
     same pipeline with K1 replaced by its plain version;
     every kernel must have launched on one of the paths;
 10. after phase 9: (o) LARS at benchmarks/ab_lars_unroll.py's shape (p=64,
     K=1024, 16,384 unit-norm signals from seed 0, encoder blocks of 2,048,
     lam=0.15) in three regimes, dense random signals (timed on
     LARS_TIME_BLOCKS blocks, printed), T-mode (n_nonzero_coefs=8) and
     planted 5-sparse + 0.02 noise: cold_unroll 0 and 12 timed in turns
     (CUDA events), patches/s, mean nnz, host syncs a block (the solver's
     counter; torch's sync debug mode on one block); on one block the
     objectives against the port's own CPU run (rtol 1e-4, atol 1e-5 on
     >= 99.9% of lanes, rtol 1e-3 on all); in lambda mode the KKT conditions on every lane
     (tests/test_lasso.py's LARS tolerance, 5e-3) and the objectives of one
     block within rtol 1e-3 of feature_sign's; in T-mode <= 8 nonzeros
     and tests/test_properties.py's knot rule; lars_path on 2,048 lanes:
     every kept knot within 5e-3 of KKT at its lambda, n_knots equal to
     the CPU run's on >= 99% of lanes; (p) config 6
     (benchmarks/run.py:374-430: 4 classes of 64x64 synthetic images, 240
     for training and 120 for testing; Whitener on 20,000 patches; K-SVD
     K=256, T=6, 8 iterations; FeatureExtractor with stride 4, levels
     (1, 2), dc+norm+whiten; LinearClassifier lam=1e-2): seconds by part,
     warm transform images/s, K1 and product launches, K1 lane by lane on
     one transform block against its plain version in float32 and float64,
     accuracy >= 0.90 and within 0.025 of the same pipeline with the plain
     K1; (q) K3's whitening epilogue fed the fitted whitener on the 512^2
     image (DC removal, and DC removal with normalization) against its
     plain version and Whitener.transform of the plainly extracted patches
     (1e-4 of the largest entry), timed one call at a time and in a CUDA
     graph; (r) the experiment runner on JSON specs in a temporary
     workspace: encode (bomp, 50,000 patches, K1), encode with LARS (4,096
     patches), the sigma=25 denoise of the 512^2 barbara stand-in (K3, K2)
     K-SVD at config 2 cut to 2 iterations, online_dl (one chunk of two
     minibatches of 2,048, K=256) and inpaint (256^2, 30% missing), each
     within 1e-5 of the direct call, the workspace's files read back
     (lc_ksvd and src need scikit-learn, which the card's machine lacks);
 11. after phase 10: (s) the device mesh (lyssandra_tpu_torch.parallel) on
     the one GPU, its slots several slots of cuda:0 (so its times are what
     the split costs): (s1) SparseEncoder("bomp", T=8, mesh=) on the
     262,144 Batch-OMP lanes with make_mesh() (1x1 here) and 4 slots, idx,
     gamma and nsel equal to the unsharded call on every lane, times in
     turns (CUDA events), host syncs a call (sync debug mode); (s2)
     omp_model_sharded at K=16,384 (above the Gram-form K1's cap), N=8,192
     on 2x4 slots against the replicated omp, which runs the residual
     form once a call (K1-L; K2-L in eps mode: an init, then a selection
     and an update launch a step): idx equal
     on >= 99.9% of lanes, gamma within 1e-4 there, eps mode nsel equal,
     time and host syncs; (s3)
     sharded_ksvd_step (4 slots) against ksvd_train_step on config 2's
     50,000 patches (K=512, T=8), model_shard_atoms on 2x2 slots on
     well-posed signals of those widths, KSVDLearner(mesh=) at
     RUN_KSVD_ITERS iterations against the unsharded fit (D within 1e-5 /
     2e-4, Gamma 1e-4 / 2e-3, tests/test_parallel.py's); (s4) the sigma=25
     denoise of the 512^2 image on 4 slots (one K3, K2 per slot), PSNR
     within 0.05 dB of the unsharded denoise, K2 on each of the route's
     64 shards of 4,096 patches at T=32 against its plain version (nsel
     and picks equal on >= 99.9% of lanes, |dgamma| <= 1e-5 ||x|| there,
     path (k)'s rule), seconds an image; (s5)
     OnlineDictionaryLearner(mesh=).fit at config 4's widths, 2 minibatches
     of 4,096 on 4 slots, D within 2e-3 of the unsharded fit; each line
     beside the card's name and power limit, and each sub-path's seconds;
 12. after phase 11, K1/K2 above the Gram form's shared-memory cap (the
     residual form, K1-L and K2-L: csrc/omp_residual.cu's init and update
     kernels around csrc/select.cu's float32 selection on the running
     lanes): (t) at p=64, K=16,384, T=8 on 32,768 Gaussian signals (K1-L;
     K2-L at eps=0.3 with half the signals scaled by 0.05) and on planted
     8-sparse ones (eps=0.05) against the plain version: idx and nsel
     equal on >= 99.9% of the Gaussian lanes and on every planted one,
     |dgamma| <= 1e-4 and err within rtol 1e-4 there; its time and by
     phase (init, selection, update: CUDA events around each launch), the
     plain version's, the selection as one PyTorch call a step
     (argmax(abs(r @ D)) at each step's running lanes), the bound (2 p K
     flops a lane and step), D's bytes streamed from L2, host syncs a call
     (at most one), K2-L at least 20% below K1-L; K2-L on lanes that finish
     at spread-out steps (0-8 planted atoms, eps=0.1) and on the same lanes
     all done on entry, held lane by lane; a call's launches (one init, a
     selection and an update a step), the step kernel's shared memory
     against the wrapper's formula, the envelope's widest factors (p=512,
     T=48 and p=64, T=100: planted signals in eps mode equal on every
     lane, p=512 in T-mode on >= 99%; p=64, T=100 over more than one chunk
     of lanes); ptxas's registers and spills for every instance of the
     residual form; then batch_omp (T-mode) and omp
     (eps mode) at 256 signals on a grid of p in (64, 512), K in (1,024,
     12,304, 12,305, 16,384, 65,536), T in (8, 32): the launch counts
     name the route, the Gram form wherever cuda_omp.kernel_supports
     holds, else the residual form, never the plain route; (n2) SRC (T=10)
     fit and predict on digits_problem(n=24,000) (16,800 training atoms,
     7,200 test images): one K1-L call a predict, accuracy within 0.02
     of the same pipeline on the plain route, K1-L's lane agreement on
     SRC's coding printed (the stand-in's atoms are coherent), fit and
     predict seconds;
then one JSON line of the results of paths (i)-(k), one of paths (l)-(n),
one of paths (o)-(r), one of path (s), one of paths (t) and (n2), one JSON
line of
per-kernel results (with each kernel's bound: the
larger of its bytes over 3.35 TB/s and its operations over the peak rate
of their type, counted from this run's data for the cheapest form of the
function, the Gram form for the greedy kernels) and, last, the result
line.
Nothing runs on the CPU when there is no GPU.
"""

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

from portbench.yardstick import work
from portbench.yardstick.peaks import bound_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
P, K, T = 64, 1024, 8               # the Batch-OMP benchmark's shape
GS, T_GROUP = 4, 4                  # the group-OMP shape (256 groups)
BENCH_BLOCK, BENCH_STEPS = 32768, 8  # 262,144 lanes, made as bench.py does
SIGMA, IMG_SIZE = 25.0, 512
COLOR_SIZE = 64                     # the p=768 colour denoise's image
REPS = 5
P4, K4, LAM, TUN = 192, 1024, 0.15, 28   # config 4: 8x8x3 patches, K=1024
N4 = 16384                               # config 4's patches, 8 blocks
N_SWEEP = 131072                         # the solver sweep's signals
# config 2 (benchmarks/run.py:93-111): K-SVD on 50,000 patches of two 512^2
# images, K=512, T=8, 20 iterations; the plain-path comparison with the
# timing by parts, and the compact-codes fit, run a few iterations each
KSVD_IMG, KSVD_N, KSVD_K, KSVD_ITERS = 512, 50000, 512, 20
KSVD_PARTS_ITERS = KSVD_COMPACT_ITERS = 3
# config 3's adaptive denoise (benchmarks/run.py:149-150)
ADAPT_TRAIN, ADAPT_ITERS = 30000, 12
# config 4's online learning (benchmarks/run.py:216-246): 100,000 + 2,048
# patches, K=1024, batch 4,096, chunks of 8 minibatches; the timed epoch
# runs ODL_CHUNKS chunks (3: all 24 minibatches), after one warm-up chunk,
# and ODL_PARTS minibatches are timed again by parts
ODL_N, ODL_HOLD, ODL_BS, ODL_CHUNKS, ODL_PARTS = 100000, 2048, 4096, 3, 2
# config 5 (benchmarks/run.py:282-327): digits-like 8x8 images in 10
# classes, 1,257 for training and 540 for testing; LC-KSVD at K=500, T=8,
# 20 iterations; SRC at T=10
DIGITS_N, LC_K, LC_ITERS, SRC_T = 1797, 500, 20, 10
# path (o), LARS at benchmarks/ab_lars_unroll.py's shape (p=64, K=1024,
# 16,384 signals in encoder blocks of 2,048, lam=LAM): the blocks timed
# per regime and the cold_unroll settings timed in turns
LARS_N, LARS_UNROLLS = 16384, (0, 12)
LARS_TIME_BLOCKS = {"dense": 2, "tmode": 8, "sparse": 8}
# config 6 (benchmarks/run.py:359-430): 4 classes of 64x64 synthetic
# images, 60 + 30 a class; whitener on 20,000 patches; K-SVD K=256, T=6,
# 8 iterations
C6_KINDS = ("smooth", "texture", "edges", "mix")
C6_SIZE, C6_TRAIN, C6_TEST, C6_WHITEN_N = 64, 60, 30, 20000
C6_K, C6_T, C6_ITERS = 256, 6, 8
# path (r), the runner: encode 50,000 patches (bomp) and 4,096 (LARS at
# lam=50 on pixel-scale patches), the sigma=25 denoise, K-SVD at config 2
# cut to RUN_KSVD_ITERS iterations
RUN_ENC_N, RUN_LARS_N, RUN_LARS_LAM, RUN_KSVD_ITERS = 50000, 4096, 50.0, 2
# the runner's online_dl (one chunk of two minibatches, lam=50 on
# pixel-scale patches) and inpaint (the runner's default 256^2 image)
RUN_ODL_N, RUN_INP_SIZE = 4096, 256
# path (s2): atom-sharded OMP above the Gram-form K1's K cap of 12,304,
# against the replicated omp through the residual-form K1-L
MESH_K, MESH_N = 16384, 8192
# paths (t) and (n2): K1/K2 above the Gram form's cap, the residual-form
# kernel at p=64, K=16,384, T=8 on 32,768 signals (eps mode: half of them
# scaled by 0.05), then a grid of (p, K, T) at 256 signals; SRC on
# digits_problem(n=24,000): 16,800 training atoms, 7,200 test images
LK_P, LK_K, LK_T, LK_N = 64, 16384, 8, 32768
LK_EPS, LK_EPS_PLANTED = 0.3, 0.05
LK_GRID_P, LK_GRID_K, LK_GRID_T = (64, 512), (1024, 12304, 12305, 16384,
                                             65536), (8, 32)
LK_GRID_N = 256
SRC_LARGE_N = 24000
# published H100 SXM peaks (NVIDIA's data sheet), for the bounds; the
# memory rate is bound_ms's own
PEAK_F32, PEAK_BF16 = 67e12, 989e12


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


def sweep_problem():
    """D and the 131,072 unit-norm Gaussian signals of the solver sweep
    (benchmarks/solver_sweep.py:19-37: same shapes, seed and draw order;
    its D is the Batch-OMP benchmark's)."""
    rng = np.random.default_rng(0)
    D = rng.standard_normal((P, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    X = rng.standard_normal((P, N_SWEEP))
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    return D.astype(np.float32), X.astype(np.float32)


def online_problem():
    """Config 4's data (benchmarks/run.py:216-235): ODL_N + ODL_HOLD
    unit-norm 8x8x3 patches of the four synthetic colour images, seed 1;
    returns (X, the holdout set)."""
    from lyssandra_tpu_torch.utils.datasets import (
        patch_dataset, synthetic_color_image,
    )

    imgs = [synthetic_color_image(k, 256, seed=s)
            for s, k in enumerate(("texture", "mix", "smooth", "edges"))]
    X = patch_dataset(imgs, p=8, n_patches=ODL_N + ODL_HOLD,
                      seed=1).astype(np.float32)
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-8)
    return X[:, :ODL_N], X[:, ODL_N:]


def digits_problem(seed=0, n=DIGITS_N, C=10, test=0.3):
    """A stand-in for sklearn's digits (config 5), which the machine with
    the card lacks: n 8x8 images in C classes with integer pixels 0..16.
    Each class is three strokes; each image moves them together by up to
    one pixel and each end by noise, draws them with a random width and
    brightness, and adds uniform noise.  Columns unit-normalized, split 70/30
    stratified by class.  Returns (Xtr, ytr, Xte, yte)."""
    rng = np.random.default_rng(seed)
    g = np.arange(8) + 0.5
    yy, xx = np.meshgrid(g, g, indexing="ij")
    pix = np.stack([yy.ravel(), xx.ravel()], axis=1)          # (64, 2)
    strokes = rng.uniform(1.0, 7.0, (C, 3, 2, 2))
    y = np.arange(n) % C
    X = np.zeros((64, n))
    for i, c in enumerate(y):
        ends = strokes[c] + rng.uniform(-1.0, 1.0, 2) + rng.normal(
            0.0, 0.5, (3, 2, 2))
        width = rng.uniform(0.55, 0.85)
        img = np.zeros(64)
        for a, b in ends:
            ab = b - a
            t = np.clip((pix - a) @ ab / max(ab @ ab, 1e-9), 0.0, 1.0)
            d2 = ((pix - a - t[:, None] * ab) ** 2).sum(axis=1)
            img = np.maximum(img, np.exp(-d2 / (2 * width ** 2)))
        img = img * rng.uniform(0.8, 1.2) + 0.15 * rng.random(64)
        X[:, i] = np.round(16 * np.clip(img, 0.0, 1.0))
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-9)
    n_te = [int(round(test * (y == c).sum())) for c in range(C)]
    te = np.concatenate([rng.permutation(np.where(y == c)[0])[:n_te[c]]
                         for c in range(C)])
    tr = np.setdiff1d(np.arange(n), te)
    return (X[:, tr].astype(np.float32), y[tr], X[:, te].astype(np.float32),
            y[te])


def distinct_atoms(torch, idx, mask):
    """The number of distinct atoms in idx where mask holds."""
    return int(torch.unique(idx[mask]).numel())


def gram_omp_flops(torch, p, K, nsel, n_atoms, gs=1):
    """portbench's ``gram_omp_flops`` of nsel, a tensor on any device."""
    return work.gram_omp_flops(p, K, nsel.cpu().numpy(), n_atoms, gs)


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


def graph_ms(torch, fn, n=20, reps=REPS):
    """Median device time of one fn() with the host's launch overhead
    taken out: n calls captured in a CUDA graph, replayed `reps` times."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # warm the allocator off the default stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n)
    del graph
    return statistics.median(times)


def count_syncs(torch, fn):
    """(fn(), the synchronizing CUDA calls it made), by portbench's
    ``count_syncs``."""
    from portbench.entries.denoise import count_syncs as syncs_of

    out = []
    n = syncs_of(lambda: out.append(fn()), torch.device("cuda"))
    return out[0], n


def hold_lanes(torch, got, want, X):
    """A fused OMP result (idx, gamma, err, nsel) against its plain
    version, lane by lane: the share of lanes with equal nsel and equal
    picks within it; on those lanes the largest |dgamma| over ||x|| and
    |derr| over ||x||^2, and the largest |dgamma| and |derr| over err;
    on the other lanes the largest |derr| over ||x||^2."""
    T = got[0].shape[1]
    keep = torch.arange(T, device=X.device)[None, :] < want[3][:, None]
    same = (got[3] == want[3]) & ((got[0] == want[0]) | ~keep).all(dim=1)
    xx = (X.double() ** 2).sum(dim=0).clamp_min(1e-12)
    dga = (got[1] - want[1]).double().abs().amax(dim=1)
    dea = (got[2] - want[2]).double().abs()
    dg, de = dga / xx.sqrt(), dea / xx

    def most(v, where):
        return float(v[where].max()) if bool(where.any()) else 0.0

    return {"agree": float(same.double().mean()),
            "gamma_rel": most(dg, same), "err_rel": most(de, same),
            "gamma_abs": most(dga, same),
            "err_rtol": most(dea / want[2].double().abs().clamp_min(1e-30),
                             same),
            "lanes_differ": int((~same).sum()),
            "differ_err_rel": most(de, ~same)}


def hold_k1(torch, cuda_omp, D, X, T):
    """K1 on (D, X) at T steps against its plain version, lane by lane
    (hold_lanes), with the share of lanes on which the kernel and the
    plain version each pick as a float64 solve does."""
    got = cuda_omp.omp_fused(D, X, T=T)
    want = cuda_omp.omp_fused_reference(D, X, T=T)
    want64 = cuda_omp.omp_fused_reference(D.double(), X.double(), T=T)
    held = hold_lanes(torch, got, want, X)
    held["kernel_f64"] = hold_lanes(torch, got, want64, X)["agree"]
    held["plain_f64"] = hold_lanes(torch, want, want64, X)["agree"]
    return held


def lcksvd_stacked(torch, lc, X, y):
    """A fitted LC-KSVD's stacked coding problem: the unit columns of
    [D_; sqrt(alpha) A_; sqrt(beta) W_], which are the fit's last D~
    rescaled, and X~ = [X; sqrt(alpha) Q; sqrt(beta) H]."""
    from lyssandra_tpu_torch.classify import one_hot
    from lyssandra_tpu_torch.classify.lc_ksvd import build_label_consistency

    sa, sb = math.sqrt(lc.cfg.alpha), math.sqrt(lc.cfg.beta)
    Dt = torch.cat([lc.D_, sa * lc.A_, sb * lc.W_], dim=0)
    Dt = Dt / torch.linalg.norm(Dt, dim=0, keepdim=True)
    Xt = torch.cat([X, sa * build_label_consistency(y, lc.cfg.K, lc.C_,
                                                    X.device),
                    sb * one_hot(y, lc.C_, X.device)], dim=0)
    return Dt, Xt


def fs_agree(torch, a, b):
    """The share of lanes on which two fused cold-start results (idx, mask,
    theta, gact, gr, done) agree in done, idx and mask, and that mask."""
    same = ((a[5] == b[5]) & (a[0] == b[0]).all(dim=1)
            & (a[1] == b[1]).all(dim=1))
    return float(same.float().mean()), same


def lasso_kkt(torch, D, X, G, lam):
    """tests/test_lasso.py's KKT residuals of codes G (K, N): the largest
    |grad + lam sign(g)| over the active entries and |grad| over the
    others, in float64."""
    Gd = G.double()
    grad = 2.0 * (D.double().T @ (D.double() @ Gd - X.double()))
    act = Gd.abs() > 1e-10
    return (float((grad + lam * torch.sign(Gd)).abs()[act].max()),
            float(grad.abs()[~act].max()))


def lasso_kkt_lanes(torch, D, X, G, lam):
    """Per lane, the widest breach of the lasso's optimality conditions in
    float64: |grad + lam sign(g)| over the nonzeros, |grad| - lam over the
    zeros."""
    Gd = G.double()
    grad = 2.0 * (D.double().T @ (D.double() @ Gd - X.double()))
    act = Gd != 0
    on = torch.where(act, (grad + lam * torch.sign(Gd)).abs(), 0.0)
    off = torch.where(act, 0.0, (grad.abs() - lam).clamp_min(0.0))
    return torch.maximum(on, off).amax(dim=0)


def lasso_objectives(torch, D, X, G, lam):
    """Per-lane lasso objectives ||x - D g||^2 + lam ||g||_1, float64."""
    R = X.double() - D.double() @ G.double()
    return (R * R).sum(dim=0) + lam * G.double().abs().sum(dim=0)


def plain_denoise(torch, noisy, D, cfg, sigma):
    """The denoise forward from the plain versions only: the patch
    pipeline, the error-stopped OMP at T1 = min(10, T_max), the lanes that
    used all T1 atoms short of eps solved again at T_max, the weighted
    reconstruction."""
    from lyssandra_tpu_torch.ops.cuda_omp import omp_fused_reference
    from lyssandra_tpu_torch.ops.cuda_patches import (
        fused_patch_pipeline_reference,
    )
    from lyssandra_tpu_torch.ops.patches import weighted_reconstruct
    from lyssandra_tpu_torch.solvers.greedy import GreedyResult, _omp_impl

    p = cfg.patch
    eps = cfg.gain * p * sigma
    T1 = min(10, cfg.T_max)
    Xc, means, _ = fused_patch_pipeline_reference(noisy, p, do_dc=True)
    r = GreedyResult(*omp_fused_reference(D, Xc, T=T1, eps=eps,
                                          eps_mode=True))
    Gamma = r.dense(D.shape[1])
    bad = torch.nonzero((r.nsel == T1) & (r.err > eps * eps))[:, 0]
    if len(bad):
        Gamma[:, bad] = _omp_impl(D, Xc[:, bad], eps, T=cfg.T_max,
                                  eps_mode=True).dense(D.shape[1])
    Xhat = D @ Gamma + means[None, :]
    return weighted_reconstruct(Xhat, noisy, p, cfg.lam / sigma)


def ksvd_paths(torch, lt, dev, img, noisy, img_d):
    """Paths (i)-(k): K-SVD at config 2's full width (dense codes, then
    compact codes) and the adaptive denoise.  Returns (the launches of each
    path, one JSON-able dict of results)."""
    import dataclasses
    import importlib

    from lyssandra_tpu_torch.utils.datasets import (
        patch_dataset, standard_test_image,
    )

    ksvd_mod = importlib.import_module("lyssandra_tpu_torch.dict_learning.ksvd")
    denoise_mod = importlib.import_module("lyssandra_tpu_torch.apps.denoise")
    cuda_omp = importlib.import_module("lyssandra_tpu_torch.ops.cuda_omp")
    block = lt.SparseEncoder().block
    out = {}

    # --- path (i): config 2 (benchmarks/run.py:93-111): 50,000 8x8 patches
    # of barbara and lena at 512^2, K=512, T=8, 20 iterations; one warm-up
    # fit of one iteration first
    imgs = [standard_test_image("barbara", KSVD_IMG),
            standard_test_image("lena", KSVD_IMG)]
    X2 = torch.as_tensor(patch_dataset(imgs, p=8, n_patches=KSVD_N)
                         .astype(np.float32), device=dev)
    cfg2 = lt.KSVDConfig(K=KSVD_K, T=8, n_iter=KSVD_ITERS)
    n_blocks = math.ceil(KSVD_N / block)
    lt.KSVDLearner(dataclasses.replace(cfg2, n_iter=1)).fit(X2)
    # the sync counter itself: two scalar reads must count two
    _, calib = count_syncs(torch, lambda: (float(X2[0, 0]), float(X2[1, 0])))
    check(calib == 2, f"sync counting: two scalar reads counted {calib}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    lt.reset_launch_counts()
    t0 = time.perf_counter()
    learner, syncs = count_syncs(torch, lambda: lt.KSVDLearner(cfg2).fit(X2))
    t_fit = time.perf_counter() - t0
    launches_i = lt.launch_counts()
    # device memory the fit took beyond what was there before it
    peak_dense = torch.cuda.max_memory_allocated(dev) - base
    print(f"path (i) KSVDLearner fit launches: {launches_i}; host syncs "
          f"{syncs}")
    check(launches_i["omp_fused_t"] == n_blocks * KSVD_ITERS
          and launches_i["gram"] == n_blocks * KSVD_ITERS
          and launches_i["ksvd_sweep"] == KSVD_ITERS,
          f"K-SVD fit: {n_blocks} K1, {n_blocks} product and one sweep "
          f"launches an iteration expected, got {launches_i}")
    hist = learner.history_
    keys = {"objective", "rmse", "avg_nnz", "atoms_replaced",
            "objective_coding", "seconds", "dispatch_seconds",
            "patches_per_sec", "iter"}            # the reference's keys
    check(len(hist) == KSVD_ITERS and all(keys <= set(h) for h in hist),
          f"K-SVD history: {len(hist)} entries, keys {sorted(hist[0])}")
    objs = [h["objective"] for h in hist]
    for h in hist:
        check(h["objective"] <= h["objective_coding"] * 1.001,
              f"K-SVD sweep phase rose at iteration {h['iter']}: {h}")
    check(all(objs[i + 1] <= objs[i] * 1.03 for i in range(len(objs) - 1)),
          f"K-SVD objective rose by more than 3%: {objs}")
    check(objs[-1] < objs[0] and all(math.isfinite(o) for o in objs),
          f"K-SVD made no progress: {objs}")
    nrm_err = float((torch.linalg.norm(learner.D_, dim=0) - 1.0).abs().max())
    check(nrm_err <= 1e-4, f"K-SVD atoms off unit norm by {nrm_err}")
    replaced = [h["atoms_replaced"] for h in hist]
    # the init draws happen on the CPU: the GPU and the CPU start alike
    D0 = lt.init_dictionary(X2, KSVD_K, "data", 0)
    D0_cpu = lt.init_dictionary(X2.cpu(), KSVD_K, "data", 0)
    init_err = float((D0.cpu() - D0_cpu).abs().max())
    check(init_err <= 1e-6, f"init_dictionary GPU against CPU: {init_err}")
    # K1 lane by lane on one coding block, from D0 (columns of X: many
    # near-duplicate atoms, whose scores tie within float32 rounding) and
    # from the learned D, against its plain version in float32 and, to tell
    # rounding from fault, in float64: the kernel must pick as the float64
    # solve does on as many lanes as a plain float32 version does (less
    # 0.5% of the lanes), and where its picks part from the plain
    # version's, leave the same residual energy within 1e-3 of ||x||^2.
    # From the learned D the picks agree on >= 99.9% of lanes.  The plain
    # Gram form codes the plain path below
    Xblk = X2[:, :block]
    held = {}
    for what, Dh in (("D0", D0), ("learned D", learner.D_)):
        got = cuda_omp.omp_fused(Dh, Xblk, T=8)
        want = cuda_omp.omp_fused_reference(Dh, Xblk, T=8)
        want64 = cuda_omp.omp_fused_reference(Dh.double(), Xblk.double(),
                                              T=8)
        gram_form = tuple(lt.batch_omp(Dh, Xblk, 8, dense=False,
                                       refresh="gram"))
        h = held[what] = hold_lanes(torch, got, want, Xblk)
        h["kernel_f64"] = hold_lanes(torch, got, want64, Xblk)["agree"]
        h["plain_f64"] = hold_lanes(torch, want, want64, Xblk)["agree"]
        h["gram_form"] = hold_lanes(torch, got, gram_form, Xblk)
        h["gram_form_f64"] = hold_lanes(torch, gram_form, want64, Xblk)
        g = h["gram_form"]
        print(f"K1 on a K-SVD block ({Xblk.shape[1]} patches, K={KSVD_K}, "
              f"T=8) from {what}: picks agree with the plain version on "
              f"{h['agree']:.6f} of lanes, there max |dgamma|/||x|| "
              f"{h['gamma_rel']:.3g}, |derr|/||x||^2 {h['err_rel']:.3g}; on "
              f"the {h['lanes_differ']} other lanes max |derr|/||x||^2 "
              f"{h['differ_err_rel']:.3g}; with float64 the kernel "
              f"agrees on {h['kernel_f64']:.6f}, the plain version on "
              f"{h['plain_f64']:.6f}; with the plain Gram form on "
              f"{g['agree']:.6f} (max |dgamma|/||x|| {g['gamma_rel']:.3g}; "
              f"{g['lanes_differ']} lanes differ, max |derr|/||x||^2 "
              f"{g['differ_err_rel']:.3g}); the plain Gram form "
              f"with float64 on {h['gram_form_f64']['agree']:.6f} (max "
              f"|dgamma|/||x|| {h['gram_form_f64']['gamma_rel']:.3g})")
    del got, want, want64, gram_form
    for what, h in held.items():
        check(h["kernel_f64"] >= min(h["plain_f64"],
                                     h["gram_form_f64"]["agree"]) - 0.005
              and h["gamma_rel"] <= 1e-4 and h["err_rel"] <= 1e-6
              and h["differ_err_rel"] <= 1e-3,
              f"K1 on a K-SVD block from {what} against its plain version: "
              f"{h}")
    check(held["learned D"]["agree"] >= 0.999,
          f"K1 on a K-SVD block from the learned D: {held['learned D']}")
    # against the plain path, iteration by iteration: the fit's first
    # iterations from D0 again, each one coded by K1 and, from the same D,
    # by the plain Gram form and by the plain residual form (no K1 launch).
    # The post-coding objectives differ only through the lanes whose picks
    # part among near-ties.  The sweep then moves D by those lanes' other
    # supports, and its objective parts by a few tenths of a percent even
    # between the two plain forms, which is printed beside
    plain_enc = lt.SparseEncoder("bomp", {"T": 8, "refresh": "gram"},
                                 check_atoms=False)
    res_enc = lt.SparseEncoder("omp", {"T": 8, "fused": False},
                               check_atoms=False)
    # seconds by parts, from CUDA events around the coding (with the
    # post-coding objective), the sweep, and the stats with the replacement
    D = D0
    parts = {"coding": [], "sweep": [], "replacement and stats": []}
    step_objs, plain_objs, step_code, plain_code = [], [], [], []
    plain_replaced, res_objs, res_code = [], [], []
    for _ in range(KSVD_PARTS_ITERS):
        lt.reset_launch_counts()
        _, _, st = ksvd_mod.ksvd_step(X2, D, plain_enc, cfg2)
        _, _, st_res = ksvd_mod.ksvd_step(X2, D, res_enc, cfg2)
        check(lt.launch_counts()["omp_fused_t"] == 0, "the plain K-SVD ran K1")
        plain_objs.append(float(st[0]))
        plain_replaced.append(int(st[3]))
        plain_code.append(float(st[4]))
        res_objs.append(float(st_res[0]))
        res_code.append(float(st_res[4]))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        Gamma = learner.encoder.encode(X2, D)
        Rc = X2 - D @ Gamma
        obj_code = (Rc * Rc).sum()
        ev[1].record()
        D, Gamma = ksvd_mod.ksvd_atom_update(X2, D, Gamma)
        ev[2].record()
        D, Gamma, st = ksvd_mod._ksvd_dense_post(X2, D, Gamma, obj_code,
                                                 cfg2)
        ev[3].record()
        ev[3].synchronize()
        step_objs.append(float(st[0]))
        step_code.append(float(st[4]))
        for i, k in enumerate(parts):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]) / 1e3)
    del Gamma, Rc
    out["ksvd_sweep"] = ksvd_sweep_case(
        torch, X2, learner.D_, learner.encoder.encode(X2, learner.D_))
    parts = {k: statistics.median(v) for k, v in parts.items()}
    same = max(abs(a / b - 1.0) for a, b in zip(step_objs, objs))
    check(same <= 1e-5, f"K-SVD by parts {step_objs} against the fit {objs}")
    code_gaps = [abs(a / b - 1.0) for a, b in zip(step_code, plain_code)]
    gaps = [abs(a / b - 1.0) for a, b in zip(step_objs, plain_objs)]
    res_code_gaps = [abs(a / b - 1.0) for a, b in zip(step_code, res_code)]
    res_gaps = [abs(a / b - 1.0) for a, b in zip(step_objs, res_objs)]
    plain_spread = max(abs(a / b - 1.0) for a, b in zip(res_objs, plain_objs))
    out["ksvd"] = {
        "N": KSVD_N, "K": KSVD_K, "T": 8, "iters": KSVD_ITERS,
        "fit_seconds": t_fit, "seconds_per_iter": t_fit / KSVD_ITERS,
        "patches_per_iter_sec": KSVD_N * KSVD_ITERS / t_fit,
        "parts_seconds_per_iter": parts, "host_syncs": syncs,
        "launches": launches_i, "atoms_replaced": replaced,
        "objective": objs, "objective_coding": [h["objective_coding"]
                                                for h in hist],
        "plain_objective": plain_objs, "plain_max_rel_gap": max(gaps),
        "coding_objective": step_code, "plain_coding_objective": plain_code,
        "plain_coding_max_rel_gap": max(code_gaps),
        "plain_atoms_replaced": plain_replaced,
        "residual_objective": res_objs, "residual_coding_objective": res_code,
        "residual_max_rel_gap": max(res_gaps),
        "residual_coding_max_rel_gap": max(res_code_gaps),
        "plain_forms_max_rel_gap": plain_spread, "k1_block": held,
        "final_rmse": hist[-1]["rmse"], "peak_bytes": peak_dense,
        "init_gpu_cpu_max_err": init_err}
    print(f"K-SVD N={KSVD_N} K={KSVD_K} T=8 {KSVD_ITERS} iterations: "
          f"{t_fit:.4f} s = {t_fit / KSVD_ITERS:.4f} s an iteration, "
          f"{KSVD_N * KSVD_ITERS / t_fit:.1f} patches x iterations/s; by "
          f"parts (s an iteration, CUDA events): " + ", ".join(
              f"{k} {v:.5f}" for k, v in parts.items())
          + f"; host syncs {syncs}; atoms replaced {replaced}; objective "
          f"{objs[0]:.2f} -> {objs[-1]:.2f}; each of the first {len(gaps)} "
          f"iterations against the plain path's from the same D: coding "
          f"objective within {max(code_gaps):.3g}, after the sweep within "
          f"{max(gaps):.3g}, atoms replaced {replaced[:len(gaps)]} against "
          f"{plain_replaced}; against the plain residual form's: coding "
          f"within {max(res_code_gaps):.3g}, after the sweep within "
          f"{max(res_gaps):.3g}; the two plain forms after the sweep within "
          f"{plain_spread:.3g} of each other; peak "
          f"{peak_dense / 2**20:.1f} MiB")
    check(max(code_gaps) <= 1e-5 and max(res_code_gaps) <= 1e-4,
          f"K-SVD coding objective against the plain path: {step_code} "
          f"against {plain_code} (Gram form), {res_code} (residual form)")
    check(max(gaps) <= 0.01 and max(res_gaps) <= 0.01,
          f"K-SVD against the plain path: {step_objs} against {plain_objs} "
          f"(Gram form), {res_objs} (residual form)")

    # --- path (j): compact codes, the same data and D0.  The compact sweep
    # runs atom blocks of 8 (Jacobi within a block), so it is held against
    # the dense route at atom_block=8 (tests/test_dict_learning.py::
    # test_ksvd_learner_compact_codes's pair)
    cfg8 = dataclasses.replace(cfg2, n_iter=KSVD_COMPACT_ITERS, atom_block=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense8 = lt.KSVDLearner(cfg8).fit(X2, D0=D0)
    t_dense8 = time.perf_counter() - t0
    dense8_objs = [h["objective"] for h in dense8.history_]
    del dense8
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    lt.reset_launch_counts()
    t0 = time.perf_counter()
    comp = lt.KSVDLearner(dataclasses.replace(cfg8, codes="compact")).fit(
        X2, D0=D0)
    t_comp = time.perf_counter() - t0
    launches_j = lt.launch_counts()
    peak_comp = torch.cuda.max_memory_allocated(dev) - base
    oc = comp.history_[-1]["objective"]
    od = dense8_objs[-1]
    print(f"path (j) compact-codes fit launches: {launches_j}")
    check(isinstance(comp.Gamma_, lt.solvers.GreedyResult),
          "compact fit: Gamma_ is not a GreedyResult")
    check(launches_j["omp_fused_t"] == n_blocks * KSVD_COMPACT_ITERS,
          f"compact fit: K1 launches {launches_j}")
    check(abs(oc - od) <= 0.05 * od,
          f"compact fit objective {oc} against the dense route's {od}")
    out["ksvd_compact"] = {
        "iters": KSVD_COMPACT_ITERS, "atom_block": 8, "seconds": t_comp,
        "objective": [h["objective"] for h in comp.history_],
        "dense_seconds": t_dense8,
        "dense_objective": dense8_objs,
        "dense_b1_objective": objs[:KSVD_COMPACT_ITERS],
        "launches": launches_j, "peak_bytes": peak_comp,
        "dense_b1_peak_bytes": peak_dense}
    print(f"K-SVD {KSVD_COMPACT_ITERS} iterations at atom_block=8: compact "
          f"codes {t_comp:.4f} s, objective {oc:.2f}; dense codes "
          f"{t_dense8:.4f} s, objective {od:.2f} (atom_block=1: "
          f"{objs[KSVD_COMPACT_ITERS - 1]:.2f}); peak device memory compact "
          f"{peak_comp / 2**20:.1f} MiB, dense at atom_block=1 "
          f"{peak_dense / 2**20:.1f} MiB")
    del comp, learner, X2

    # --- path (k): the adaptive denoise of the 512^2 image at sigma=25
    # (benchmarks/run.py:149-150), K2 launches counted apart for the
    # training and the denoise
    cfg_k = lt.DenoiseConfig(sigma=SIGMA, T_max=16)
    at_denoise = {}
    real_call = denoise_mod.Denoiser.__call__

    def counted_call(self, *a, **kw):
        at_denoise.update(lt.launch_counts())
        return real_call(self, *a, **kw)

    n_train_blocks = math.ceil(ADAPT_TRAIN / block)
    denoise_mod.Denoiser.__call__ = counted_call
    try:
        torch.cuda.synchronize()
        lt.reset_launch_counts()
        t0 = time.perf_counter()
        out_k, D_k = denoise_mod.denoise_adaptive(
            noisy, SIGMA, cfg=cfg_k, K=256, n_iter=ADAPT_ITERS,
            n_train=ADAPT_TRAIN, return_dictionary=True)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
    finally:
        denoise_mod.Denoiser.__call__ = real_call
    launches_k = lt.launch_counts()
    train_k = {k: at_denoise[k] for k in launches_k}
    den_k = {k: launches_k[k] - at_denoise[k] for k in launches_k}
    print(f"path (k) denoise_adaptive launches: training {train_k}, "
          f"denoise {den_k}")
    check(train_k["omp_fused_eps"] == n_train_blocks * ADAPT_ITERS
          and den_k["omp_fused_eps"] == 1 and den_k["fused_patches"] == 1,
          f"adaptive denoise launches: training {train_k}, denoise {den_k}")
    check(tuple(out_k.shape) == tuple(img.shape)
          and bool(torch.isfinite(out_k).all()), "adaptive denoise output")
    p_noisy = lt.psnr(noisy, img_d)
    p_adapt = lt.psnr(out_k, img_d)
    p_dct = lt.psnr(denoise_mod.Denoiser(lt.dct_dictionary(8, 256, device=dev),
                                         cfg_k)(noisy), img_d)
    check(p_adapt > p_noisy + 3.0, f"adaptive denoise PSNR {p_adapt} against "
          f"the noisy {p_noisy}")
    check(p_adapt >= p_dct - 0.1, f"adaptive denoise PSNR {p_adapt} against "
          f"the DCT denoise's {p_dct}")
    # K2 as the training ran it (T=16, the training eps) on the first
    # block of the training patches, with the learned D, against its plain
    # version; then the same denoise from the plain versions with that D
    eps_k = cfg_k.gain * cfg_k.patch * SIGMA
    train = patch_dataset([noisy.cpu().numpy().astype(np.float64)],
                          p=cfg_k.patch, n_patches=ADAPT_TRAIN, seed=3)
    Xt = torch.as_tensor(train[:, :block].astype(np.float32), device=dev)
    got = cuda_omp.omp_fused(D_k, Xt, T=cfg_k.T_max, eps=eps_k,
                             eps_mode=True)
    want = cuda_omp.omp_fused_reference(D_k, Xt, T=cfg_k.T_max, eps=eps_k,
                                        eps_mode=True)
    held_k = hold_lanes(torch, got, want, Xt)
    held_k["nsel_agree"] = float((got[3] == want[3]).double().mean())
    held_k["max_abs_err"] = float((got[1] - want[1]).abs().max())
    held_k["mean_nsel"] = float(got[3].double().mean())
    del got, want
    p_plain = lt.psnr(plain_denoise(torch, noisy, D_k, cfg_k, SIGMA), img_d)
    print(f"K2 on an adaptive-denoise training block ({Xt.shape[1]} "
          f"patches, K=256, T={cfg_k.T_max}, eps={eps_k}) with the learned "
          f"D: nsel agree on {held_k['nsel_agree']:.6f} of lanes, nsel and "
          f"picks on {held_k['agree']:.6f}, mean nsel "
          f"{held_k['mean_nsel']:.3f}; max |dgamma| "
          f"{held_k['max_abs_err']:.3g} (on agreeing lanes "
          f"{held_k['gamma_rel']:.3g} of ||x||); plain denoise with the "
          f"learned D {p_plain:.4f} dB")
    check(held_k["nsel_agree"] >= 0.999 and held_k["agree"] >= 0.999
          and held_k["gamma_rel"] <= 1e-5,
          f"K2 on a training block against its plain version: {held_k}")
    check(abs(p_adapt - p_plain) <= 0.05, f"adaptive denoise PSNR {p_adapt} "
          f"against {p_plain} from the plain versions with the same D")
    out["denoise_adaptive"] = {
        "size": IMG_SIZE, "sigma": SIGMA, "K": 256, "n_iter": ADAPT_ITERS,
        "n_train": ADAPT_TRAIN, "T_max": 16, "seconds": t_k,
        "psnr": p_adapt, "psnr_noisy": p_noisy, "psnr_dct": p_dct,
        "psnr_plain": p_plain, "k2_training_block": held_k,
        "launches_training": train_k, "launches_denoise": den_k}
    print(f"adaptive denoise {IMG_SIZE}^2 sigma={SIGMA} (K=256, "
          f"{ADAPT_ITERS} iterations on {ADAPT_TRAIN} patches, T_max=16): "
          f"{t_k:.4f} s; PSNR noisy {p_noisy:.4f} dB, DCT {p_dct:.4f} dB, "
          f"adaptive {p_adapt:.4f} dB, plain versions with its D "
          f"{p_plain:.4f} dB")
    return (launches_i, launches_j, launches_k), out


def ksvd_sweep_case(torch, X, D, Gamma):
    """K10, K-SVD's sweep kernel (csrc/ksvd_sweep.cu), at config 2 from a
    learned D and its codes from K1: one sweep against the dense sweep in
    float64 of the same float32 inputs (atom distances, held to the ksvd-c2
    check's limits, 1e-4 largest and 1e-6 median), two launches bit for
    bit, then one sweep timed (CUDA events, median of REPS warm calls)
    beside the plain version (the dense sweep, eager) and, as the yardstick
    (library_ms), the dense sweep replayed from its CUDA graph, the path
    the kernel took over.  The bound: the users' rows of Rt read once and
    written once and the code rows read and written once at the card's
    bandwidth, 8 p flops a code; a chain of K dependent steps, it is not
    the kernel's bound, so the time an atom is the figure to watch."""
    import importlib

    sw = importlib.import_module("lyssandra_tpu_torch.ops.cuda_ksvd_sweep")
    tksvd = importlib.import_module("lyssandra_tpu_torch.dict_learning.ksvd")
    p, N = X.shape
    K = D.shape[1]
    got = sw.ksvd_sweep_fused(X, D, Gamma, 1)
    again = sw.ksvd_sweep_fused(X, D, Gamma, 1)
    repeats = all(torch.equal(a, b) for a, b in zip(got, again))
    want = tksvd._sweep(X.double(), D.double(), Gamma.double(), 1, 1)
    gaps = torch.linalg.vector_norm(got[0].double() - want[0], dim=0)
    gap_max, gap_median = float(gaps.max()), float(gaps.median())
    del want, again
    nnz = float((Gamma != 0).sum())
    kernel_ms = cuda_ms(torch, lambda: sw.ksvd_sweep_fused(X, D, Gamma, 1))
    plain_ms = cuda_ms(torch, lambda: tksvd._sweep(X, D, Gamma, 1, 1),
                       reps=1)
    # the dense sweep's graph: its first call runs eager, its second
    # captures, the rest replay (the median of REPS)
    takes = sw.takes
    sw.takes = lambda *a: False
    try:
        graph_ms_ = cuda_ms(torch, lambda: tksvd.ksvd_atom_update(X, D, Gamma))
    finally:
        sw.takes = takes
    bound = bound_ms(4.0 * (2 * p * nnz + 2 * K * N), 8.0 * p * nnz)
    print(f"K10 K-SVD sweep at p={p}, K={K}, N={N} ({nnz / K:.1f} users an "
          f"atom) from the learned D: atom distance to the float64 sweep max "
          f"{gap_max:.3g}, median {gap_median:.3g}; two launches "
          f"{'agree' if repeats else 'DIFFER'} bit for bit; one sweep "
          f"{kernel_ms:.4f} ms ({kernel_ms * 1e3 / K:.3f} us an atom); "
          f"plain version {plain_ms:.3f} ms; dense sweep replayed "
          f"{graph_ms_:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]})")
    check(gap_max <= 1e-4 and gap_median <= 1e-6,
          f"K10 against the float64 sweep: max {gap_max}, median "
          f"{gap_median}")
    check(repeats, "K10: two launches gave different bits")
    check(kernel_ms < 10.0, f"K10: one config-2 sweep took {kernel_ms} ms")
    return {"p": p, "K": K, "N": N, "users_per_atom": nnz / K,
            "gap_max": gap_max, "gap_median": gap_median,
            "ms": kernel_ms, "us_per_atom": kernel_ms * 1e3 / K,
            "plain_ms": plain_ms, "library_ms": graph_ms_,
            "bound_ms": bound[0], "bound_by": bound[1]}


def sweep_kernel_case(torch, D, A, B):
    """K9, the online sweep kernel (csrc/online_sweep.cu), at config 4 from
    a learned state (D, A, B): one sweep against the sweep in float64 of
    the same float32 inputs (atom distances, held to the online check's
    limits, 1e-5 largest and 1e-6 median), then one sweep timed (CUDA
    events, median of REPS warm calls) at every cluster of 4 CTAs or more
    that fits and at the one ``cluster_size`` picks, beside the plain loop.
    The bound: 2 p K flops an atom, K atoms, at the float32 peak, against
    D, A and B read and D written once; a chain of K dependent steps, it
    is not the kernel's bound, so the time an atom is the figure to
    watch."""
    import importlib

    from lyssandra_tpu_torch import _build

    sw = importlib.import_module(
        "lyssandra_tpu_torch.ops.cuda_online_sweep")
    p, K = D.shape
    got = sw.online_sweep_fused(D, A, B, 1)
    want = sw.online_sweep_reference(D.double(), A.double(), B.double(), 1)
    gaps = torch.linalg.vector_norm(got.double() - want, dim=0)
    gap_max, gap_median = float(gaps.max()), float(gaps.median())
    chosen = sw.cluster_size(p, K)
    by_cluster = {c: cuda_ms(torch, lambda c=c: sw.online_sweep_fused(
        D, A, B, 1, cluster=c)) for c in sw.CLUSTERS
        if c >= 4 and sw.smem_bytes(p, K, c) <= _build.SMEM_PER_BLOCK}
    kernel_ms = cuda_ms(torch, lambda: sw.online_sweep_fused(D, A, B, 1))
    plain_ms = cuda_ms(torch, lambda: sw.online_sweep_reference(D, A, B, 1))
    bound = bound_ms(4.0 * (3 * p * K + K * K), 2.0 * p * K * K)
    dead = int((torch.diagonal(A) < 1e-10).sum())
    print(f"K9 online sweep at p={p}, K={K} from the learned state ({dead} "
          f"dead atoms): atom distance to the float64 sweep max "
          f"{gap_max:.3g}, median {gap_median:.3g}; one sweep "
          f"{kernel_ms:.4f} ms at c={chosen} "
          f"({kernel_ms * 1e3 / K:.3f} us an atom), by cluster "
          + ", ".join(f"c={c} {t:.4f}" for c, t in by_cluster.items())
          + f" ms; plain loop {plain_ms:.3f} ms; bound {bound[0]:.4f} ms "
          f"({bound[1]})")
    check(gap_max <= 1e-5 and gap_median <= 1e-6,
          f"K9 against the float64 sweep: max {gap_max}, median "
          f"{gap_median}")
    check(kernel_ms < 5.0, f"K9: one config-4 sweep took {kernel_ms} ms")
    return {"p": p, "K": K, "dead_atoms": dead, "gap_max": gap_max,
            "gap_median": gap_median, "cluster": chosen, "ms": kernel_ms,
            "us_per_atom": kernel_ms * 1e3 / K, "by_cluster_ms": by_cluster,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1]}


def learning_paths(torch, lt, dev):
    """Paths (l)-(n): online dictionary learning at config 4's full width
    (``fit``, then ``partial_fit``) and config 5's classifiers.  Returns
    (the launches of each path, one JSON-able dict of results)."""
    import importlib

    online = importlib.import_module(
        "lyssandra_tpu_torch.dict_learning.online")
    cuda_omp = importlib.import_module("lyssandra_tpu_torch.ops.cuda_omp")
    from lyssandra_tpu_torch.ops.cuda_fs import (
        fs_cold_fused, fs_cold_fused_reference,
    )
    from lyssandra_tpu_torch.solvers.lasso import host_syncs

    out = {}
    X, Xh = online_problem()
    X, Xh = torch.as_tensor(X, device=dev), torch.as_tensor(Xh, device=dev)
    cfg4 = lt.OnlineDLConfig(K=K4, lam=LAM, batch_size=ODL_BS)
    chunk = cfg4.chunk_batches * ODL_BS
    n_fit = min(ODL_CHUNKS * chunk, ODL_N)
    n_mb = n_fit // ODL_BS
    full_mb = ODL_N // ODL_BS
    print(f"path (l) depth: {n_mb} of the epoch's {full_mb} minibatches "
          f"({ODL_CHUNKS} chunks of {cfg4.chunk_batches})")

    # --- path (l): fit at config 4 (benchmarks/run.py:216-246).  A warm-up
    # fit of one chunk first, its host syncs counted with torch's sync
    # debug mode; then the timed epoch, its syncs counted by the solver's
    # own counter (no debug-mode overhead in the time)
    warm, syncs_warm = count_syncs(torch, lambda: lt.OnlineDictionaryLearner(
        cfg4).fit(X[:, :chunk], holdout=Xh))
    del warm
    learner = lt.OnlineDictionaryLearner(cfg4)
    torch.cuda.synchronize()
    lt.reset_launch_counts()
    s0 = host_syncs()
    t0 = time.perf_counter()
    learner.fit(X[:, :n_fit], n_epochs=1, holdout=Xh)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    solver_syncs = host_syncs() - s0
    launches_l = lt.launch_counts()
    print(f"path (l) OnlineDictionaryLearner.fit launches: {launches_l}")
    n_calls = cfg4.code_blocks * n_mb
    check(launches_l["fs_scan"] == n_calls
          and launches_l["gram"] == 2 * n_calls
          and launches_l["online_sweep"] == n_mb
          and sum(launches_l.values()) == 3 * n_calls + n_mb,
          f"online fit: one fs_scan and two product launches a coding "
          f"block ({n_calls} blocks) and one sweep launch a minibatch "
          f"({n_mb}) expected, got {launches_l}")
    hist = learner.history_
    keys = {"step", "batch_objective", "avg_nnz", "holdout_objective",
            "seconds", "patches_per_sec"}            # the reference's keys
    check(len(hist) == ODL_CHUNKS and all(keys == set(h) for h in hist),
          f"online history: {len(hist)} entries, keys {sorted(hist[0])}")
    trace = [h["holdout_objective"] for h in hist]
    check(all(math.isfinite(v) for v in trace) and trace[-1] < trace[0],
          f"online holdout objective did not fall: {trace}")
    D = learner.D_
    nrm_max = float(torch.linalg.norm(D, dim=0).max())
    check(tuple(D.shape) == (P4, K4) and nrm_max <= 1.0 + 1e-5
          and bool(torch.isfinite(D).all()), f"online D: atom norm {nrm_max}")

    # one more minibatch through _online_chunk from the learned state, its
    # in-loop codes recorded: A and B grow by Gamma Gamma^T and X Gamma^T
    # (float64, within 1e-4 of their norms); the codes meet the KKT
    # conditions, and their objectives are within rtol 1e-3 of
    # feature_sign's plain path from the same D
    st = learner.state
    perm = np.random.default_rng(1).permutation(n_fit)[:ODL_BS]
    Xb = X[:, torch.from_numpy(perm).to(dev)]
    codes = []
    real_code = online._code_batch

    def recording(*a, **kw):
        codes.append(real_code(*a, **kw))
        return codes[-1]

    online._code_batch = recording
    try:
        _, A1, B1, _, _ = online._online_chunk(
            st.D, st.A, st.B, Xb[None], cfg4.lam, cfg4.beta,
            n_sweeps=cfg4.n_sweeps, coder="feature_sign",
            max_active=cfg4.fs_max_active, max_iter=cfg4.fs_max_iter,
            max_inner=cfg4.fs_max_inner, code_blocks=cfg4.code_blocks)
    finally:
        online._code_batch = real_code
    G = codes[0].double()
    dA = (A1.double() - st.A.double()) - G @ G.T
    dB = (B1.double() - st.B.double()) - Xb.double() @ G.T
    inc_a = float(torch.linalg.norm(dA) / torch.linalg.norm(G @ G.T))
    inc_b = float(torch.linalg.norm(dB) / torch.linalg.norm(Xb.double() @ G.T))
    viol_act, viol_inact = lasso_kkt(torch, D, Xb, codes[0], LAM)
    Gx = lt.feature_sign(D, Xb, LAM, cold_backend="xla", cold_unroll=0)
    o_in = lasso_objectives(torch, D, Xb, codes[0], LAM)
    o_x = lasso_objectives(torch, D, Xb, Gx, LAM)
    obj_gap = float(((o_in - o_x).abs() / o_x.clamp_min(1e-12)).max())
    print(f"online step from the learned state: |dA - G G^T| / |G G^T| "
          f"{inc_a:.3g}, |dB - X G^T| / |X G^T| {inc_b:.3g}; in-loop codes: "
          f"KKT active {viol_act:.3g}, inactive max {viol_inact:.6f}; "
          f"objectives within {obj_gap:.3g} (relative) of feature_sign "
          f"(cold_backend='xla', cold_unroll=0); mean nnz "
          f"{float((G.abs() > 1e-10).sum(dim=0).double().mean()):.3f}")
    check(inc_a <= 1e-4 and inc_b <= 1e-4,
          f"online statistics increments: A {inc_a}, B {inc_b}")
    check(viol_act < 1e-3 and viol_inact <= LAM + 1e-3,
          f"online in-loop codes KKT: active {viol_act}, inactive "
          f"{viol_inact}")
    check(obj_gap <= 1e-3, f"online in-loop objectives against feature_sign: "
          f"{obj_gap}")
    del Gx, G, dA, dB, codes

    # by parts (CUDA events): coding (its host syncs by the solver's
    # counter), statistics, atom sweep from the learned state, then the
    # holdout objective once
    opts = dict(max_active=cfg4.fs_max_active, max_iter=cfg4.fs_max_iter,
                max_inner=cfg4.fs_max_inner, warm_start=0, cold_unroll=0)
    parts = {"coding": [], "statistics": [], "atom sweep": []}
    parts_syncs = []
    Dp, Ap, Bp = st.D, st.A, st.B
    for i in range(ODL_PARTS):
        Xp = X[:, i * ODL_BS:(i + 1) * ODL_BS]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        s0 = host_syncs()
        ev[0].record()
        Gp = online._code_batch(Dp, Xp, LAM, "feature_sign", opts,
                                cfg4.code_blocks)
        ev[1].record()
        parts_syncs.append(host_syncs() - s0)
        Ap = Ap + Gp @ Gp.T
        Bp = Bp + Xp @ Gp.T
        ev[2].record()
        Dp = online._dict_update_body(Dp, Ap, Bp, cfg4.n_sweeps)
        ev[3].record()
        ev[3].synchronize()
        for j, k in enumerate(parts):
            parts[k].append(ev[j].elapsed_time(ev[j + 1]) / 1e3)
    parts = {k: statistics.median(v) for k, v in parts.items()}
    parts["holdout (s a chunk)"] = cuda_ms(
        torch, lambda: online.holdout_objective(Dp, Xh, LAM), reps=3) / 1e3
    del Dp, Ap, Bp, Gp
    out["online_sweep"] = sweep_kernel_case(torch, st.D, st.A, st.B)
    out["online_fit"] = {
        "N": n_fit, "epoch_N": ODL_N, "K": K4, "p": P4, "lam": LAM,
        "batch_size": ODL_BS, "chunk_batches": cfg4.chunk_batches,
        "code_blocks": cfg4.code_blocks, "minibatches": n_mb,
        "seconds": t_fit, "patches_per_sec": n_mb * ODL_BS / t_fit,
        "chunk_seconds": [h["seconds"] for h in hist],
        "holdout_objective": trace,
        "avg_nnz": [h["avg_nnz"] for h in hist],
        "parts_seconds_per_minibatch": parts,
        "host_syncs_per_minibatch_warmup": syncs_warm / cfg4.chunk_batches,
        "solver_syncs_per_minibatch": solver_syncs / n_mb,
        "solver_syncs_by_parts": parts_syncs,
        "increment_rel_err": [inc_a, inc_b],
        "kkt": [viol_act, viol_inact], "objective_rel_gap": obj_gap,
        "launches": launches_l}
    print(f"online fit at config 4 ({n_mb} minibatches of {ODL_BS}, K={K4}, "
          f"p={P4}): {t_fit:.4f} s = {n_mb * ODL_BS / t_fit:.1f} patches/s; "
          f"chunks {[round(h['seconds'], 4) for h in hist]} s; holdout "
          f"objective {trace}; by parts (s a minibatch, CUDA events): "
          + ", ".join(f"{k} {v:.5f}" for k, v in parts.items())
          + f"; host syncs a minibatch: {syncs_warm / cfg4.chunk_batches:.1f}"
          f" (sync debug mode, warm-up chunk from a data D0), solver's "
          f"counter {solver_syncs / n_mb:.1f} (timed epoch), {parts_syncs} "
          f"(by parts, from the learned D)")

    # --- path (m): partial_fit, three minibatches of a stream, each one
    # feature_sign call (one K6 and two product launches); against fit over
    # the same minibatches from the same initial state
    X3 = X[:, :3 * ODL_BS]
    perm3 = np.random.default_rng(11).permutation(3 * ODL_BS)
    mbs = [X3[:, torch.from_numpy(perm3[i * ODL_BS:(i + 1) * ODL_BS]).to(dev)]
           for i in range(3)]
    D0 = lt.init_dictionary(mbs[0], K4, "data", cfg4.seed)
    state0 = lt.OnlineDLState(
        D0, torch.zeros((K4, K4), device=dev), torch.zeros((P4, K4),
                                                           device=dev),
        torch.zeros((), dtype=torch.int32))
    pf = lt.OnlineDictionaryLearner(cfg4)
    pf.state = state0
    torch.cuda.synchronize()
    lt.reset_launch_counts()
    t0 = time.perf_counter()
    for Xb in mbs:
        pf.partial_fit(Xb)
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    launches_m = lt.launch_counts()
    print(f"path (m) partial_fit launches: {launches_m}")
    check(launches_m["fs_cold"] == 3 and launches_m["gram"] == 6
          and launches_m["online_sweep"] == 3
          and sum(launches_m.values()) == 12,
          f"partial_fit: one K6, two product and one sweep launch a "
          f"minibatch expected, got {launches_m}")
    got = fs_cold_fused(D0, mbs[0], lam=LAM, t_unroll=TUN)
    want = fs_cold_fused_reference(D0, mbs[0], lam=LAM, t_unroll=TUN)
    want64 = fs_cold_fused_reference(D0.double(), mbs[0].double(), lam=LAM,
                                     t_unroll=TUN)
    k6_agree, _ = fs_agree(torch, got, want)
    k6_agree64, _ = fs_agree(torch, want64, want)
    k6_done = [float(got[5].float().mean()), float(want[5].float().mean())]
    del got, want, want64
    ft = lt.OnlineDictionaryLearner(cfg4)
    ft.state = state0
    ft.fit(X3, seed=11)
    h_pf = float(online.holdout_objective(pf.D_, Xh, LAM))
    h_ft = float(online.holdout_objective(ft.D_, Xh, LAM))
    print(f"K6 on the first partial_fit minibatch ({ODL_BS} patches) from "
          f"D0: done/idx/mask agree with the plain version on {k6_agree:.6f} "
          f"of lanes (plain in float64 against float32: {k6_agree64:.6f}); "
          f"done at the handoff: kernel {k6_done[0]:.6f}, plain "
          f"{k6_done[1]:.6f}; partial_fit x 3 {t_pf:.4f} s; holdout "
          f"objective partial_fit {h_pf:.6f}, fit {h_ft:.6f}")
    check(k6_agree >= k6_agree64 - 0.1
          and abs(k6_done[0] - k6_done[1]) <= 0.005,
          f"K6 on a partial_fit minibatch: {k6_agree} (float64 {k6_agree64}),"
          f" done {k6_done}")
    check(abs(h_pf - h_ft) <= 0.01 * h_ft,
          f"partial_fit holdout {h_pf} against fit's {h_ft}")
    out["online_partial_fit"] = {
        "minibatches": 3, "seconds": t_pf, "launches": launches_m,
        "k6_agree": k6_agree, "k6_plain_f64_agree": k6_agree64,
        "k6_done": k6_done, "holdout_partial_fit": h_pf,
        "holdout_fit": h_ft}
    del learner, pf, ft, X, X3, mbs, state0, st

    # --- path (n): config 5, LC-KSVD and SRC on digits-like data
    Xtr, ytr, Xte, yte = digits_problem()
    Xtr, Xte = torch.as_tensor(Xtr, device=dev), torch.as_tensor(Xte,
                                                                 device=dev)
    lc_cfg = lt.LCKSVDConfig(K=LC_K, T=8, n_iter=LC_ITERS)

    def classify():
        """LC-KSVD and SRC fitted and scored; launches of the fit and the
        scoring apart; times on the host clock after a device sync."""
        r = {}
        torch.cuda.synchronize()
        lt.reset_launch_counts()
        t0 = time.perf_counter()
        lc = lt.LCKSVD(lc_cfg).fit(Xtr, ytr)
        torch.cuda.synchronize()
        r["lcksvd_fit_s"] = time.perf_counter() - t0
        r["launches_fit"] = lt.launch_counts()
        lt.reset_launch_counts()
        t0 = time.perf_counter()
        r["lcksvd_accuracy"] = lc.score(Xte, yte)
        r["lcksvd_predict_s"] = time.perf_counter() - t0
        r["launches_predict"] = lt.launch_counts()
        lt.reset_launch_counts()
        t0 = time.perf_counter()
        src = lt.SRCClassifier(T=SRC_T).fit(Xtr, ytr)
        r["src_accuracy"] = src.score(Xte, yte)
        r["src_predict_s"] = time.perf_counter() - t0
        r["launches_src"] = lt.launch_counts()
        r["timings"] = lc.timings_
        return r, lc, src

    kernel, lc, src = classify()
    nrm_err = float((torch.linalg.norm(lc.D_, dim=0) - 1.0).abs().max())
    print(f"path (n) LC-KSVD fit launches: {kernel['launches_fit']}; predict "
          f"{kernel['launches_predict']}; SRC {kernel['launches_src']}")
    check(kernel["launches_fit"]["omp_fused_t"] == LC_ITERS + 1
          and kernel["launches_fit"]["gram"] == LC_ITERS + 1,
          f"LC-KSVD fit: {LC_ITERS + 1} K1 and product launches expected "
          f"(ridge init, every stacked iteration)")
    for k in ("launches_predict", "launches_src"):
        check(kernel[k]["omp_fused_t"] == 1 and kernel[k]["gram"] == 1,
              f"{k}: one K1 and one product launch expected, got {kernel[k]}")
    check(tuple(lc.D_.shape) == (64, LC_K) and tuple(lc.A_.shape)
          == (LC_K, LC_K) and tuple(lc.W_.shape) == (10, LC_K)
          and nrm_err <= 1e-4, f"LC-KSVD D_, A_, W_: shapes, norm {nrm_err}")
    # K1 on SRC's coding (K = 1,257 training samples, T=10) lane by lane
    Xn = Xte / torch.linalg.norm(Xte, dim=0, keepdim=True).clamp_min(1e-12)
    held = hold_k1(torch, cuda_omp, src.D_, Xn, SRC_T)
    # K1 on LC-KSVD's stacked coding (p = 64 + K + C = 574, K=500, T=8, the
    # 1,257 training lanes with their label-consistency and one-hot rows)
    # from the learned stacked dictionary
    held_lc = hold_k1(torch, cuda_omp, *lcksvd_stacked(torch, lc, Xtr, ytr),
                      8)
    # the same pipeline with K1 replaced by its plain version
    real_k1 = cuda_omp.omp_fused
    cuda_omp.omp_fused = cuda_omp.omp_fused_reference
    try:
        plain, _, _ = classify()
    finally:
        cuda_omp.omp_fused = real_k1
    check(plain["launches_fit"]["omp_fused_t"] == 0,
          "the plain classifiers ran K1")
    print(f"K1 on SRC's coding ({Xn.shape[1]} lanes, K={src.D_.shape[1]}, "
          f"T={SRC_T}): picks agree with the plain version on "
          f"{held['agree']:.6f} of lanes, there max |dgamma|/||x|| "
          f"{held['gamma_rel']:.3g}, |derr|/||x||^2 {held['err_rel']:.3g}; "
          f"on the {held['lanes_differ']} other lanes max |derr|/||x||^2 "
          f"{held['differ_err_rel']:.3g}; with float64 the kernel agrees on "
          f"{held['kernel_f64']:.6f}, the plain version on "
          f"{held['plain_f64']:.6f}")
    print(f"K1 on LC-KSVD's stacked coding ({Xtr.shape[1]} lanes, p="
          f"{64 + LC_K + 10}, K={LC_K}, T=8) from the learned stacked D: picks "
          f"agree with the plain version on {held_lc['agree']:.6f} of lanes, "
          f"there max |dgamma|/||x|| {held_lc['gamma_rel']:.3g}, "
          f"|derr|/||x||^2 {held_lc['err_rel']:.3g}; on the "
          f"{held_lc['lanes_differ']} other lanes max |derr|/||x||^2 "
          f"{held_lc['differ_err_rel']:.3g}; with float64 the kernel agrees "
          f"on {held_lc['kernel_f64']:.6f}, the plain version on "
          f"{held_lc['plain_f64']:.6f}")
    print(f"config 5 (digits-like, {Xtr.shape[1]} train, {Xte.shape[1]} test):"
          f" LC-KSVD K={LC_K} T=8 {LC_ITERS} iterations fit "
          f"{kernel['lcksvd_fit_s']:.4f} s (" + ", ".join(
              f"{k} {v:.4f}" for k, v in kernel["timings"].items())
          + f"), accuracy {kernel['lcksvd_accuracy']:.4f} (plain K1 "
          f"{plain['lcksvd_accuracy']:.4f}), predict "
          f"{kernel['lcksvd_predict_s']:.4f} s; SRC T={SRC_T} predict "
          f"{kernel['src_predict_s']:.4f} s, accuracy "
          f"{kernel['src_accuracy']:.4f} (plain K1 "
          f"{plain['src_accuracy']:.4f}); plain pipeline: fit "
          f"{plain['lcksvd_fit_s']:.4f} s, SRC {plain['src_predict_s']:.4f} s")
    check(held["kernel_f64"] >= held["plain_f64"] - 0.005
          and held["gamma_rel"] <= 1e-4 and held["err_rel"] <= 1e-6
          and held["differ_err_rel"] <= 1e-3,
          f"K1 on SRC's coding against its plain version: {held}")
    check(held_lc["kernel_f64"] >= held_lc["plain_f64"] - 0.005
          and held_lc["gamma_rel"] <= 1e-4 and held_lc["err_rel"] <= 1e-6
          and held_lc["differ_err_rel"] <= 1e-3,
          f"K1 on LC-KSVD's stacked coding against its plain version: "
          f"{held_lc}")
    for k in ("lcksvd_accuracy", "src_accuracy"):
        check(kernel[k] > 0.8 and abs(kernel[k] - plain[k]) <= 0.02,
              f"{k} {kernel[k]} against {plain[k]} with the plain K1")
    out["classify"] = {
        "n_train": Xtr.shape[1], "n_test": Xte.shape[1], "K": LC_K, "T": 8,
        "n_iter": LC_ITERS, "src_T": SRC_T, "kernel": kernel,
        "plain": plain, "k1_src_lanes": held, "k1_stacked_lanes": held_lc,
        "history_objective": [h["objective"] for h in lc.history_]}
    launches_n = {k: kernel["launches_fit"][k] + kernel["launches_predict"][k]
                  + kernel["launches_src"][k] for k in kernel["launches_fit"]}
    return (launches_l, launches_m, launches_n), out


def lars_problem():
    """benchmarks/ab_lars_unroll.py's data (same shapes, seed and draw
    order): a unit-norm Gaussian D (p=64, K=1024), LARS_N unit-norm
    Gaussian signals (the dense regime) and LARS_N planted 5-sparse signals
    plus 0.02 noise, unit-normalized (the sparse regime)."""
    rng = np.random.default_rng(0)
    D = rng.standard_normal((P, K))
    D /= np.linalg.norm(D, axis=0)
    X = rng.standard_normal((P, LARS_N))
    X /= np.linalg.norm(X, axis=0)
    idx = rng.integers(0, K, (LARS_N, 5))
    coef = rng.standard_normal((LARS_N, 5))
    Xs = np.zeros((P, LARS_N), np.float32)
    for j in range(5):
        Xs += (D[:, idx[:, j]] * coef[:, j]).astype(np.float32)
    Xs += 0.02 * rng.standard_normal((P, LARS_N)).astype(np.float32)
    Xs /= np.linalg.norm(Xs, axis=0)
    return D.astype(np.float32), X.astype(np.float32), Xs


def knot_kkt(torch, D, X, G):
    """tests/test_properties.py's T-mode rule: a T-mode LARS lane stops at
    a knot, its active atoms' |grad| on a common boundary bnd (their
    largest).  Returns the largest deviation from it over the lanes,
    relative to max(bnd, 1), and the share of lanes with an inactive atom
    above bnd (1 + 1e-3) + 1e-3, a late join after a heal (float64)."""
    Gd = G.double()
    grad = (2.0 * (D.double().T @ (D.double() @ Gd - X.double()))).abs()
    act = Gd.abs() > 1e-12
    bnd = torch.where(act, grad, 0.0).amax(dim=0)
    dev = torch.where(act, (grad - bnd).abs(), 0.0).amax(dim=0)
    over = torch.where(act, 0.0, grad).amax(dim=0) > bnd * (1 + 1e-3) + 1e-3
    return (float((dev / bnd.clamp_min(1.0)).max()),
            float(over[act.any(dim=0)].double().mean()))


def path_kkt(torch, D, X, path):
    """The kept knots of a LarsPath against the lasso KKT conditions at
    their own penalty (tests/test_lasso.py's per-knot check): the share of
    kept knots whose active |grad| is within 5e-3 of the knot's lambda and
    whose inactive |grad| is at most lambda + 5e-3, and the largest
    violation."""
    K = D.shape[1]
    Dd, Xd = D.double(), X.double()
    G, A0 = Dd.T @ Dd, Dd.T @ Xd
    ok = kept = 0
    worst = 0.0
    for s in range(path.lambdas.shape[0]):
        keep = path.keep[s]
        if not bool(keep.any()):
            continue
        g = torch.zeros(X.shape[1], K, dtype=torch.float64, device=X.device)
        g.scatter_add_(1, path.idx[s].long(), torch.where(
            path.mask[s], path.coefs[s], 0.0).double())
        g = g.T
        gr = 2.0 * (G @ g - A0)
        lam = path.lambdas[s].double()[None, :]
        act = g.abs() > 1e-10
        viol = torch.where(act, (gr.abs() - lam).abs(),
                           (gr.abs() - lam).clamp_min(0.0)).amax(dim=0)
        kept += int(keep.sum())
        ok += int(((viol <= 5e-3) & keep).sum())
        worst = max(worst, float(viol[keep].max()))
    return ok / max(kept, 1), worst, kept


def lars_paths(torch, lt, dev):
    """Path (o): the LARS-lasso homotopy at benchmarks/ab_lars_unroll.py's
    shape in its three regimes, and lars_path.  Returns (the launches of
    the path, one JSON-able dict of results)."""
    from lyssandra_tpu_torch.solvers.lasso import host_syncs

    D, X, Xs = lars_problem()
    cpu = torch.device("cpu")
    Dd = torch.as_tensor(D, device=dev)
    block = lt.SparseEncoder("lars").block
    regimes = (("dense", X, {"lam": LAM}),
               ("tmode", X, {"n_nonzero_coefs": 8}),
               ("sparse", Xs, {"lam": LAM}))
    out = {}
    launches = None
    for name, Xr, params in regimes:
        lam = params.get("lam", 0.0)
        n_time = LARS_TIME_BLOCKS[name] * block
        if n_time < LARS_N:
            print(f"path (o) {name}: timing cut to {n_time} of the "
                  f"{LARS_N} signals ({n_time // block} blocks of {block})")
        Xt = torch.as_tensor(Xr[:, :n_time], device=dev)
        res = {u: {"ms": [], "syncs": []} for u in LARS_UNROLLS}
        codes = {}
        lt.reset_launch_counts()
        for u in LARS_UNROLLS + LARS_UNROLLS[::-1]:       # in turns
            enc = lt.SparseEncoder("lars", {**params, "cold_unroll": u})
            torch.cuda.synchronize()
            s0 = host_syncs()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            G = enc.encode(Xt, Dd)
            ev[1].record()
            ev[1].synchronize()
            res[u]["ms"].append(ev[0].elapsed_time(ev[1]))
            res[u]["syncs"].append((host_syncs() - s0) / (n_time // block))
            codes[u] = G
        launches_r = lt.launch_counts()
        launches = launches_r if launches is None else {
            k: launches[k] + launches_r[k] for k in launches}
        # torch's sync debug mode on one block, cold_unroll 12
        Xb = Xt[:, :block]
        _, dbg_syncs = count_syncs(torch, lambda: lt.lars(
            Dd, Xb, cold_unroll=LARS_UNROLLS[-1], **params))
        G = codes[LARS_UNROLLS[-1]]
        nnz = (G.abs() > 1e-8).sum(dim=0)
        # one block against the port's own CPU run (cold_unroll None = 0
        # there)
        Xh = torch.as_tensor(Xr[:, :block])
        t0 = time.perf_counter()
        Gc = lt.lars(torch.as_tensor(D), Xh, **params).to(dev)
        cpu_s = time.perf_counter() - t0
        o_c = lasso_objectives(torch, Dd, Xh.to(dev), Gc, lam)
        held = {}
        for u in LARS_UNROLLS:
            o_g = lasso_objectives(torch, Dd, Xh.to(dev),
                                   codes[u][:, :block], lam)
            gap = (o_g - o_c).abs()
            n_out = int((gap > 1e-5 + 1e-4 * o_c.abs()).sum())
            rel = float((gap / o_c.abs().clamp_min(1e-12)).max())
            held[u] = {"lanes_beyond_rtol_1e-4": n_out, "max_rel_gap": rel}
            check(n_out <= block // 1000 and rel <= 1e-3,
                  f"LARS {name} cold_unroll={u} against the CPU run: "
                  f"{n_out} lanes beyond rtol 1e-4, max relative gap {rel}")
        r = {"n_timed": n_time, "block": block, "params": params,
             "ms_per_call": {u: v["ms"] for u, v in res.items()},
             "patches_per_s": {u: n_time / statistics.median(v["ms"]) * 1e3
                               for u, v in res.items()},
             "host_syncs_per_block": {u: v["syncs"] for u, v in res.items()},
             "debug_mode_syncs_one_block": dbg_syncs,
             "mean_nnz": float(nnz.double().mean()),
             "cpu_hold_lanes": block, "cpu_seconds": cpu_s,
             "cpu_hold": held}
        if name == "tmode":
            check(int(nnz.max()) <= 8, f"LARS T-mode: {int(nnz.max())} > 8 "
                  f"nonzeros on a lane")
            r["knot_kkt"], r["overdue_share"] = knot_kkt(torch, Dd, Xt, G)
            check(r["knot_kkt"] < 5e-3 and r["overdue_share"] <= 0.25,
                  f"LARS T-mode knot KKT {r['knot_kkt']}, lanes with a late "
                  f"join {r['overdue_share']}")
        else:
            va, vi = lasso_kkt(torch, Dd, Xt, G, lam)
            r["kkt"] = [va, vi]
            check(va < 5e-3 and vi <= lam + 5e-3,
                  f"LARS {name} KKT after polish: active {va}, inactive {vi}")
            # the same optimum as feature-sign on one block
            Gf = lt.feature_sign(Dd, Xb, lam)
            o_f = lasso_objectives(torch, Dd, Xb, Gf, lam)
            o_l = lasso_objectives(torch, Dd, Xb, G[:, :block], lam)
            r["feature_sign_max_rel_gap"] = float(
                ((o_l - o_f).abs() / o_f.clamp_min(1e-12)).max())
            check(r["feature_sign_max_rel_gap"] <= 1e-3,
                  f"LARS {name} against feature_sign: "
                  f"{r['feature_sign_max_rel_gap']}")
        out[name] = r
        print(f"LARS {name} ({params}) p={P} K={K} N={n_time}, blocks of "
              f"{block}: " + "; ".join(
                  f"cold_unroll={u} {statistics.median(v['ms']) / 1e3:.4f} s "
                  f"a call ({', '.join(f'{m / 1e3:.4f}' for m in v['ms'])}) "
                  f"= {r['patches_per_s'][u]:.1f} patches/s, host syncs a "
                  f"block {v['syncs']}" for u, v in res.items())
              + f"; sync debug mode on one block (cold_unroll="
              f"{LARS_UNROLLS[-1]}) {dbg_syncs}; mean nnz {r['mean_nnz']:.3f}"
              f"; against the CPU run on {block} lanes ({cpu_s:.2f} s): "
              + ", ".join(f"cold_unroll={u} {h['lanes_beyond_rtol_1e-4']} "
                          f"lanes beyond rtol 1e-4, max rel gap "
                          f"{h['max_rel_gap']:.3g}" for u, h in held.items())
              + (f"; knot KKT {r['knot_kkt']:.3g}, share of lanes with a "
                 f"late join {r['overdue_share']:.6f}" if name == "tmode" else
                 f"; KKT active {r['kkt'][0]:.3g}, inactive max "
                 f"{r['kkt'][1]:.6f}; against feature_sign max rel gap "
                 f"{r['feature_sign_max_rel_gap']:.3g}"))
        del codes, G, Xt

    # lars_path on one block of the sparse regime, and on the CPU
    Xp = torch.as_tensor(Xs[:, :block], device=dev)
    lt.reset_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    path = lt.lars_path(Dd, Xp, LAM)
    ev[1].record()
    ev[1].synchronize()
    launches_p = lt.launch_counts()
    launches = {k: launches[k] + launches_p[k] for k in launches}
    path_ms = ev[0].elapsed_time(ev[1])
    t0 = time.perf_counter()
    path_c = lt.lars_path(torch.as_tensor(D), Xp.to(cpu), LAM)
    cpu_s = time.perf_counter() - t0
    same = float((path.n_knots.cpu() == path_c.n_knots).double().mean())
    share, worst, kept = path_kkt(torch, Dd, Xp, path)
    print(f"lars_path sparse regime, {block} lanes, lam {LAM}, "
          f"{path.lambdas.shape[0] - 1} steps: {path_ms / 1e3:.4f} s (CPU "
          f"{cpu_s:.2f} s); kept knots {kept}, mean n_knots "
          f"{float(path.n_knots.double().mean()):.3f}; n_knots equal to the "
          f"CPU run's on {same:.6f} of lanes; KKT at their lambda within "
          f"5e-3 on {share:.6f} of kept knots, worst {worst:.3g}")
    check(same >= 0.99, f"lars_path n_knots against the CPU run: {same}")
    check(share == 1.0, f"lars_path kept knots off KKT: share {share}, "
          f"worst {worst}")
    out["lars_path"] = {"lanes": block, "ms": path_ms, "cpu_seconds": cpu_s,
                        "kept_knots": kept, "n_knots_equal_cpu": same,
                        "kkt_share": share, "kkt_worst": worst}
    out["launches"] = launches
    return launches, out


def config6_problem():
    """Config 6's data (benchmarks/run.py:374-394): 4 classes of
    synthetic_image at 64x64, C6_TRAIN training and C6_TEST test images a
    class, plus noise 4.0 drawn from default_rng(11) in the benchmark's
    order.  Returns (train images, ytr, test images, yte)."""
    from lyssandra_tpu_torch.utils.datasets import synthetic_image

    rng = np.random.default_rng(11)

    def make(cls, n, seed0):
        return [synthetic_image(C6_KINDS[cls], C6_SIZE, seed=seed0 + 7 * i)
                + 4.0 * rng.standard_normal((C6_SIZE, C6_SIZE))
                for i in range(n)]

    train = [(im, c) for c in range(4) for im in make(c, C6_TRAIN, 1000 + c)]
    test = [(im, c) for c in range(4) for im in make(c, C6_TEST, 9000 + c)]
    return (np.stack([im for im, _ in train]).astype(np.float32),
            np.array([c for _, c in train]),
            np.stack([im for im, _ in test]).astype(np.float32),
            np.array([c for _, c in test]))


def feature_paths(torch, lt, dev):
    """Paths (p) and (q): config 6's recognition pipeline at full width
    (whitener, K-SVD dictionary, feature extraction, linear classifier),
    with the kernel K1 and with its plain version; then K3's whitening
    epilogue fed the fitted whitener.  Returns (the launches of (p), those
    of (q), one JSON-able dict of results)."""
    import importlib

    import torch.nn.functional as F

    from lyssandra_tpu_torch.ops.cuda_patches import (
        fused_patch_pipeline_p1, fused_patch_pipeline_reference,
    )
    from lyssandra_tpu_torch.ops.patches import (
        contrast_normalize, extract_patches, remove_dc,
    )
    from lyssandra_tpu_torch.utils.datasets import (
        patch_dataset, synthetic_image,
    )

    cuda_omp = importlib.import_module("lyssandra_tpu_torch.ops.cuda_omp")
    imgs_tr, ytr, imgs_te, yte = config6_problem()
    Xp = patch_dataset(list(imgs_tr.astype(np.float64)), p=8,
                       n_patches=C6_WHITEN_N, seed=2).astype(np.float32)
    Xp = torch.as_tensor(Xp, device=dev)
    tr = torch.as_tensor(imgs_tr, device=dev)
    te = torch.as_tensor(imgs_te, device=dev)

    def pipeline():
        """Config 6's stages, each timed on the host clock after a device
        sync; the launches of the whole run."""
        r = {}
        torch.cuda.synchronize()
        lt.reset_launch_counts()
        t0 = time.perf_counter()
        Xn, _ = contrast_normalize(remove_dc(Xp)[0])
        wh = lt.Whitener().fit(Xn)
        Xw = wh.transform(Xn)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        learner = lt.KSVDLearner(lt.KSVDConfig(
            K=C6_K, T=C6_T, n_iter=C6_ITERS, init="data")).fit(Xw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fe = lt.FeatureExtractor(learner.D_, patch=8, stride=4,
                                 levels=(1, 2), preprocess="dc+norm+whiten",
                                 whitener=wh)
        Ftr = fe.transform(tr)
        Fte = fe.transform(te)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        clf = lt.LinearClassifier(lam=1e-2).fit(Ftr.T, ytr)
        acc = clf.score(Fte.T, yte)
        t4 = time.perf_counter()
        # the same ridge formed and solved in float32 (fault C4)
        Z = Ftr.T
        W32 = torch.linalg.solve(
            Z @ Z.T + 1e-2 * torch.eye(Z.shape[0], device=dev),
            Z @ lt.classify.one_hot(ytr, 4, dev).T).T
        r["accuracy_float32_ridge"] = float(
            ((W32 @ Fte.T).argmax(dim=0).cpu().numpy() == yte).mean())
        r["launches"] = lt.launch_counts()
        r["seconds"] = {"whitener": t1 - t0, "ksvd": t2 - t1,
                        "transform (cold)": t3 - t2, "classifier": t4 - t3}
        r["accuracy"] = acc
        r["feature_dim"] = int(Ftr.shape[1])
        r["objective_trace"] = [h["objective"] for h in learner.history_]
        return r, wh, fe, Ftr

    kernel, wh, fe, Ftr = pipeline()
    # warm transform of all images, CUDA events
    n_img = tr.shape[0] + te.shape[0]
    ms = cuda_ms(torch, lambda: (fe.transform(tr), fe.transform(te)),
                 reps=3)
    kernel["images_per_s_warm"] = n_img / ms * 1e3
    print(f"path (p) config 6 launches: {kernel['launches']}")
    check(kernel["launches"]["omp_fused_t"] > 0
          and kernel["launches"]["gram"] > 0,
          f"config 6 launched no K1 or no product: {kernel['launches']}")
    check(tuple(Ftr.shape) == (tr.shape[0], C6_K * 5)
          and bool(torch.isfinite(Ftr).all()), "config 6 features: shape, "
          "finite")
    # K1 lane by lane on one transform block (the first img_block training
    # images' whitened patches, T=10) from the learned D
    blk = tr[:fe.img_block]
    Xb = F.unfold(blk[:, None], 8, stride=4)
    Xb = fe._preprocess(Xb.transpose(0, 1).reshape(64, -1)).contiguous()
    held = hold_k1(torch, cuda_omp, fe.D, Xb, 10)
    # the same pipeline with K1 replaced by its plain version
    real_k1 = cuda_omp.omp_fused
    cuda_omp.omp_fused = cuda_omp.omp_fused_reference
    try:
        plain, _, _, _ = pipeline()
    finally:
        cuda_omp.omp_fused = real_k1
    check(plain["launches"]["omp_fused_t"] == 0, "the plain pipeline ran K1")
    print(f"K1 on a config-6 transform block ({Xb.shape[1]} lanes, K={C6_K}, "
          f"T=10) from the learned D: picks agree with the plain version on "
          f"{held['agree']:.6f} of lanes, there max |dgamma|/||x|| "
          f"{held['gamma_rel']:.3g}, |derr|/||x||^2 {held['err_rel']:.3g}; on "
          f"the {held['lanes_differ']} other lanes max |derr|/||x||^2 "
          f"{held['differ_err_rel']:.3g}; with float64 the kernel agrees on "
          f"{held['kernel_f64']:.6f}, the plain version on "
          f"{held['plain_f64']:.6f}")
    print(f"config 6 ({tr.shape[0]} train, {te.shape[0]} test images of "
          f"{C6_SIZE}^2, K={C6_K}, T={C6_T}, {C6_ITERS} K-SVD iterations): "
          f"fit by part (s) " + ", ".join(
              f"{k} {v:.4f}" for k, v in kernel["seconds"].items())
          + f"; warm transform {ms / 1e3:.4f} s = "
          f"{kernel['images_per_s_warm']:.1f} images/s; accuracy "
          f"{kernel['accuracy']:.4f} (plain K1 {plain['accuracy']:.4f}; "
          f"with the ridge in float32 {kernel['accuracy_float32_ridge']:.4f}"
          f"); "
          f"feature dim {kernel['feature_dim']}; K-SVD objective "
          f"{kernel['objective_trace'][0]:.4f} -> "
          f"{kernel['objective_trace'][-1]:.4f}")
    check(held["kernel_f64"] >= held["plain_f64"] - 0.005
          and held["gamma_rel"] <= 1e-4 and held["err_rel"] <= 1e-6
          and held["differ_err_rel"] <= 1e-3,
          f"K1 on config 6's coding against its plain version: {held}")
    check(kernel["accuracy"] >= 0.90
          and abs(kernel["accuracy"] - plain["accuracy"]) <= 0.025,
          f"config 6 accuracy {kernel['accuracy']} against "
          f"{plain['accuracy']} with the plain K1")
    out = {"config6": {"kernel": kernel, "plain": plain, "k1_lanes": held}}

    # --- path (q): K3's whitening epilogue with the fitted whitener on a
    # 512^2 image: against its plain version and against
    # Whitener.transform of the plainly extracted patches
    img = torch.as_tensor(synthetic_image("texture", IMG_SIZE, seed=0),
                          dtype=torch.float32, device=dev)
    wf = wh.fused_params()
    variants = (("dc+whiten", {}), ("dc+norm+whiten", {"do_norm": True}))
    lt.reset_launch_counts()
    outs = [lt.ops.fused_patch_pipeline(img, 8, whiten=wf, **kw)
            for _, kw in variants]
    torch.cuda.synchronize()
    launches_q = lt.launch_counts()
    check(launches_q["fused_patches"] == len(variants),
          f"path (q): one K3 launch a call expected, got {launches_q}")
    q = {}
    for (what, kw), got in zip(variants, outs):
        want = fused_patch_pipeline_reference(img, 8, whiten=wf, **kw)
        Xe, _ = remove_dc(extract_patches(img, 8))
        if kw:
            Xe, _ = contrast_normalize(Xe)
        tr_ = wh.transform(Xe)
        scale = max(1.0, float(want[0].abs().max()))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        err_t = float((got[0] - tr_).abs().max())
        ms_q = cuda_ms(torch, lambda: fused_patch_pipeline_p1(
            img, 8, whiten=wf, **kw))
        g_ms = graph_ms(torch, lambda: fused_patch_pipeline_p1(
            img, 8, whiten=wf, **kw))
        q[what] = {"max_abs_err": err, "max_abs_err_transform": err_t,
                   "scale": scale, "ms": ms_q, "graph_ms": g_ms}
        print(f"path (q) K3 {what} with config 6's whitener, {IMG_SIZE}^2: "
              f"max |d| to the plain version {err:.3g}, to Whitener."
              f"transform {err_t:.3g} (largest |x| {scale:.4g}); "
              f"{ms_q:.4f} ms a call, {g_ms:.4f} ms in a CUDA graph")
        check(err <= 1e-4 * scale and err_t <= 1e-4 * scale,
              f"K3 {what} with a fitted whitener: {err}, {err_t} "
              f"(scale {scale})")
    out["k3_whiten"] = q
    return kernel["launches"], launches_q, out


def runner_paths(torch, lt, dev):
    """Path (r): the experiment runner on JSON specs in a temporary
    workspace (encode through K1, LARS, the denoise through K3 and K2,
    K-SVD at config 2 cut to RUN_KSVD_ITERS iterations), each against the
    direct call; the workspace files read back.  Returns (the launches,
    one JSON-able dict of results)."""
    import tempfile

    from lyssandra_tpu_torch.experiments import run_experiment
    from lyssandra_tpu_torch.utils.datasets import (
        patch_dataset, standard_test_image,
    )

    out = {}
    launches = None
    imgs = [standard_test_image(n, KSVD_IMG) for n in ("barbara", "lena")]
    print(f"path (r) depth: ksvd {RUN_KSVD_ITERS} of config 2's "
          f"{KSVD_ITERS} iterations")
    with tempfile.TemporaryDirectory() as tmp:
        specs = {
            "encode": {"task": "encode", "data": {
                "images": ["barbara", "lena"], "size": KSVD_IMG,
                "n_patches": RUN_ENC_N, "patch": 8, "K": 256},
                "params": {"algorithm": "bomp", "T": 8}},
            "encode_lars": {"task": "encode", "data": {
                "images": ["barbara", "lena"], "size": KSVD_IMG,
                "n_patches": RUN_LARS_N, "patch": 8, "K": 256},
                "params": {"algorithm": "lars", "lam": RUN_LARS_LAM}},
            "denoise": {"task": "denoise", "data": {
                "images": ["barbara"], "size": IMG_SIZE, "K": 256,
                "seed": 7}, "params": {"sigma": SIGMA}},
            "ksvd": {"task": "ksvd", "data": {
                "images": ["barbara", "lena"], "size": KSVD_IMG,
                "n_patches": KSVD_N, "patch": 8},
                "params": {"K": KSVD_K, "T": 8, "n_iter": RUN_KSVD_ITERS}},
            "online_dl": {"task": "online_dl", "data": {
                "images": ["barbara", "lena"], "size": KSVD_IMG,
                "n_patches": RUN_ODL_N, "patch": 8},
                "params": {"K": 256, "lam": RUN_LARS_LAM,
                           "batch_size": RUN_ODL_N // 2, "chunk_batches": 2}},
            "inpaint": {"task": "inpaint", "data": {
                "images": ["lena"], "size": RUN_INP_SIZE, "K": 256,
                "seed": 0}, "params": {"missing_frac": 0.3, "T": 8}},
        }
        for name, spec in specs.items():
            ws = os.path.join(tmp, name)
            path = os.path.join(tmp, f"{name}.json")
            with open(path, "w") as f:
                json.dump(dict(spec, workspace=ws), f)
            torch.cuda.synchronize()
            lt.reset_launch_counts()
            t0 = time.perf_counter()
            got = run_experiment(path)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = lt.launch_counts()
            launches = counts if launches is None else {
                k: launches[k] + counts[k] for k in launches}
            with open(os.path.join(ws, "result.json")) as f:
                check(json.load(f) == json.loads(json.dumps(got)),
                      f"runner {name}: result.json differs from the result")
            data = spec["data"]
            if spec["task"] == "encode":
                X = torch.as_tensor(patch_dataset(
                    imgs, p=8, n_patches=data["n_patches"], seed=0).astype(
                        np.float32), device=dev)
                D = lt.dct_dictionary(8, 256)
                params = dict(spec["params"])
                G = lt.SparseEncoder(params.pop("algorithm"), params,
                                     check_atoms=False).encode(X, D)
                want = {"rel_err": float(torch.linalg.norm(X - D @ G)
                                         / torch.linalg.norm(X)),
                        "avg_nnz": float((G.abs() > 1e-10).sum(dim=0)
                                         .double().mean())}
                with np.load(os.path.join(ws, "Gamma.npz")) as z:
                    saved = torch.as_tensor(z["Gamma"], device=dev)
                check(torch.equal(saved, G) or float(
                    (saved - G).abs().max()) <= 1e-5,
                    f"runner {name}: saved Gamma differs from the direct "
                    f"call's")
            elif spec["task"] == "denoise":
                img = standard_test_image("barbara", IMG_SIZE)
                noisy = img + SIGMA * np.random.default_rng(7)\
                    .standard_normal(img.shape)
                den = lt.denoise(noisy.astype(np.float32),
                                 lt.dct_dictionary(8, 256), SIGMA,
                                 cfg=lt.DenoiseConfig(sigma=SIGMA))
                want = {"psnr": lt.psnr(den, img),
                        "psnr_noisy": lt.psnr(noisy, img)}
                with np.load(os.path.join(ws, "denoised.npz")) as z:
                    check(z["img"].shape == (IMG_SIZE, IMG_SIZE),
                          "runner denoise: saved image shape")
            elif spec["task"] == "online_dl":
                X = patch_dataset(imgs, p=8, n_patches=RUN_ODL_N,
                                  seed=0).astype(np.float32)
                learner = lt.OnlineDictionaryLearner(lt.OnlineDLConfig(
                    **spec["params"])).fit(X)
                want = {k: learner.history_[-1][k]
                        for k in ("step", "batch_objective", "avg_nnz")}
                got = dict(got, **{k: got["history"][k] for k in want})
                with np.load(os.path.join(ws, "D.npz")) as z:
                    check(z["D"].shape == (64, 256),
                          "runner online_dl: saved D shape")
            elif spec["task"] == "inpaint":
                img = standard_test_image("lena", RUN_INP_SIZE)
                mask = (np.random.default_rng(0).uniform(size=img.shape)
                        > 0.3).astype(np.float64)
                rec = lt.apps.inpaint(img * mask, mask,
                                      lt.dct_dictionary(8, 256), T=8)
                rec = rec.cpu().numpy().astype(np.float64)
                miss = mask == 0
                want = {"psnr_inpainted": lt.psnr(rec[miss], img[miss])}
                with np.load(os.path.join(ws, "inpainted.npz")) as z:
                    check(z["img"].shape == img.shape,
                          "runner inpaint: saved image shape")
            else:
                X = patch_dataset(imgs, p=8, n_patches=KSVD_N,
                                  seed=0).astype(np.float32)
                learner = lt.KSVDLearner(lt.KSVDConfig(
                    K=KSVD_K, T=8, n_iter=RUN_KSVD_ITERS)).fit(X)
                want = {"objective_trace": [h["objective"]
                                            for h in learner.history_],
                        "final_rmse": learner.history_[-1]["rmse"]}
                with np.load(os.path.join(ws, "D.npz")) as z:
                    check(z["D"].shape == (64, KSVD_K),
                          "runner ksvd: saved D shape")
            gaps = {k: float(np.max(np.abs(np.subtract(got[k], v))
                                    / np.maximum(np.abs(v), 1e-12)))
                    for k, v in want.items()}
            out[name] = {"result": got, "direct": want, "rel_gaps": gaps,
                         "seconds": secs, "launches": counts}
            print(f"path (r) runner {name}: {secs:.3f} s, launches {counts}; "
                  f"result {got}; relative gaps to the direct call {gaps}")
            check(all(g <= 1e-5 for g in gaps.values()),
                  f"runner {name} against the direct call: {gaps}")
    check(launches["omp_fused_t"] > 0 and launches["omp_fused_eps"] > 0
          and launches["fused_patches"] > 0,
          f"path (r): K1, K2 and K3 expected, got {launches}")
    return launches, out

def mesh_paths(torch, lt, dev, card, Db, Xb, Dd, img_d, noisy, gpus=None):
    """Path (s): the device mesh (lyssandra_tpu_torch.parallel) at full
    width.  Its slots go to ``gpus`` in turn (default: [dev], so on one GPU
    they are several slots of cuda:0 and the times are what the split
    costs, not a speed-up; ``tools/mesh_gpus.py`` passes every GPU of the
    machine).  Inputs and results lie on dev.  (s1) data-sharded Batch-OMP
    at the benchmark's shape; (s2) atom-sharded OMP above K1's K cap;
    (s3) sharded K-SVD at config 2's widths; (s4) the sharded denoise;
    (s5) sharded online learning at config 4's widths.  Returns (the
    launches of the sharded calls, one JSON-able dict of results)."""
    import dataclasses

    from lyssandra_tpu_torch.ops.cuda_omp import (
        omp_fused, omp_fused_reference,
    )
    from lyssandra_tpu_torch.ops.cuda_patches import fused_patch_pipeline
    from lyssandra_tpu_torch.parallel import (
        ksvd_train_step, make_mesh, omp_model_sharded, sharded_ksvd_step,
    )
    from lyssandra_tpu_torch.parallel.mesh import data_shards, row_copies
    from lyssandra_tpu_torch.solvers.greedy import _route_of
    from lyssandra_tpu_torch.utils.datasets import (
        patch_dataset, standard_test_image,
    )

    out = {}
    launches = None

    def counted(fn):
        """fn() with the kernel launches it makes added to the path's."""
        nonlocal launches
        torch.cuda.synchronize()
        lt.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        counts = lt.launch_counts()
        launches = counts if launches is None else {
            k: launches[k] + counts[k] for k in launches}
        return res, counts

    gpus = gpus or [dev]

    def slots(data, model=1):
        n = data * model
        return make_mesh(data, model,
                         devices=[gpus[i % len(gpus)] for i in range(n)])

    # --- (s1) data-sharded Batch-OMP at the benchmark's shape
    t_s = time.perf_counter()
    N = Xb.shape[1]
    single = lt.SparseEncoder("bomp", {"T": T})
    want = single.encode(Xb, Db, dense=False)
    s1 = {}
    for name, mesh in (("make_mesh()", make_mesh()), ("data=4", slots(4))):
        enc = lt.SparseEncoder("bomp", {"T": T}, mesh=mesh)
        got, counts = counted(lambda: enc.encode(Xb, Db, dense=False))
        idx_eq = float((got.idx == want.idx).all(dim=1).double().mean())
        gamma_eq = bool(torch.equal(got.gamma, want.gamma))
        check(idx_eq == 1.0 and gamma_eq and torch.equal(got.nsel, want.nsel),
              f"(s1) {name}: idx equal on {idx_eq} of the lanes, gamma "
              f"bitwise {gamma_eq}")
        ms_sh, ms_un = [], []
        for _ in range(3):                      # in turns
            ms_sh.append(cuda_ms(torch, lambda: enc.encode(
                Xb, Db, dense=False), reps=3))
            ms_un.append(cuda_ms(torch, lambda: single.encode(
                Xb, Db, dense=False), reps=3))
        _, syncs = count_syncs(torch, lambda: enc.encode(Xb, Db, dense=False))
        _, syncs_un = count_syncs(torch, lambda: single.encode(
            Xb, Db, dense=False))
        sh, un = statistics.median(ms_sh), statistics.median(ms_un)
        s1[name] = {"mesh": mesh.shape, "launches": counts,
                    "idx_equal": idx_eq, "gamma_bitwise": gamma_eq,
                    "ms": sh, "unsharded_ms": un,
                    "patches_per_s": N / sh * 1e3,
                    "unsharded_patches_per_s": N / un * 1e3,
                    "ratio": sh / un, "host_syncs": syncs,
                    "unsharded_host_syncs": syncs_un}
        print(f"[{card}] (s1) bomp encode p={P} K={K} T={T} N={N} mesh "
              f"{name} {mesh.shape}: idx equal on {idx_eq:.6f} of the "
              f"lanes, gamma bitwise {gamma_eq}; sharded {sh:.3f} ms = "
              f"{N / sh * 1e3:.1f} patches/s, unsharded {un:.3f} ms = "
              f"{N / un * 1e3:.1f} patches/s (ratio {sh / un:.3f}); host "
              f"syncs a call {syncs} (unsharded {syncs_un}); launches "
              f"{counts}")
    check(s1["data=4"]["launches"]["omp_fused_t"] == 4 * math.ceil(
        N / single.block), f"(s1) K1 launches {s1['data=4']['launches']}")
    out["s1"] = s1
    out["s1_seconds"] = time.perf_counter() - t_s

    # --- (s2) atom-sharded OMP above the Gram form's K cap, against the
    # replicated omp, which takes the residual form (K1-L) there
    t_s = time.perf_counter()
    Kb, Nb = MESH_K, MESH_N
    rng = np.random.default_rng(11)
    D2, X2 = make_problem(rng, P, Kb, Nb, T)
    D2, X2 = torch.as_tensor(D2, device=dev), torch.as_tensor(X2, device=dev)
    check(_route_of(D2, X2, T) == "residual",
          f"(s2) K={Kb} must take the residual form")
    mesh = slots(2, 4)
    (res, counts) = counted(lambda: omp_model_sharded(
        D2, X2, T, mesh=mesh, dense=False))
    (ref, counts_rep) = counted(lambda: lt.omp(D2, X2, T, dense=False))
    want = {"omp_residual_t": 1, "omp_residual_select": T,
            "omp_residual_update": T}
    check(counts_rep == {k: want.get(k, 0) for k in counts_rep},
          f"(s2) the replicated omp: one K1-L call ({want}) expected, got "
          f"{counts_rep}")
    same = (res.idx == ref.idx).all(dim=1) & (res.nsel == ref.nsel)
    agree = float(same.double().mean())
    dg = float((res.gamma - ref.gamma)[same].abs().max())
    check(agree >= 0.999 and dg <= 1e-4,
          f"(s2) idx equal on {agree} of the lanes, gamma {dg}")
    ms_sh = cuda_ms(torch, lambda: omp_model_sharded(
        D2, X2, T, mesh=mesh, dense=False), reps=3)
    ms_rep = cuda_ms(torch, lambda: lt.omp(D2, X2, T, dense=False), reps=3)
    _, syncs = count_syncs(torch, lambda: omp_model_sharded(
        D2, X2, T, mesh=mesh, dense=False))
    Xe = X2.clone()
    Xe[:, ::2] *= 0.05
    eps = 0.3
    re = omp_model_sharded(D2, Xe, T, eps=eps, mesh=mesh, dense=False)
    (rr, counts_eps) = counted(lambda: lt.omp(D2, Xe, T, eps=eps,
                                              dense=False))
    want = {"omp_residual_eps": 1, "omp_residual_select": T,
            "omp_residual_update": T}
    check(counts_eps == {k: want.get(k, 0) for k in counts_eps},
          f"(s2) the replicated omp, eps mode: one K2-L call ({want}) "
          f"expected, got {counts_eps}")
    nsel_eq = float((re.nsel == rr.nsel).double().mean())
    _, syncs_eps = count_syncs(torch, lambda: omp_model_sharded(
        D2, Xe, T, eps=eps, mesh=mesh, dense=False))
    check(nsel_eq == 1.0, f"(s2) eps mode: nsel equal on {nsel_eq}")
    out["s2"] = {"mesh": mesh.shape, "K": Kb, "N": Nb, "idx_equal": agree,
                 "gamma_max_diff": dg, "ms": ms_sh, "replicated_ms": ms_rep,
                 "host_syncs": syncs, "eps_nsel_equal": nsel_eq,
                 "eps_mean_nsel": float(re.nsel.double().mean()),
                 "eps_host_syncs": syncs_eps, "launches": counts,
                 "replicated_launches": counts_rep,
                 "replicated_eps_launches": counts_eps,
                 "seconds": time.perf_counter() - t_s}
    print(f"[{card}] (s2) omp_model_sharded p={P} K={Kb} T={T} N={Nb} mesh "
          f"{mesh.shape}: idx equal on {agree:.6f} of the lanes, gamma "
          f"within {dg:.2e} there; {ms_sh:.3f} ms ({Nb / ms_sh * 1e3:.1f} "
          f"patches/s), replicated omp (K1-L) {ms_rep:.3f} ms; host syncs "
          f"a call {syncs}; eps={eps}: nsel equal on {nsel_eq:.6f}, mean nsel "
          f"{out['s2']['eps_mean_nsel']:.3f}, host syncs {syncs_eps}")
    del D2, X2, Xe, res, ref, re, rr

    # --- (s3) sharded K-SVD at config 2's widths, cut to RUN_KSVD_ITERS
    t_s = time.perf_counter()
    print(f"path (s3) depth: the learner {RUN_KSVD_ITERS} of config 2's "
          f"{KSVD_ITERS} iterations; one step each of the sharded steps")
    imgs = [standard_test_image(n, KSVD_IMG) for n in ("barbara", "lena")]
    X3 = torch.as_tensor(patch_dataset(imgs, p=8, n_patches=KSVD_N)
                         .astype(np.float32), device=dev)
    D0 = lt.init_dictionary(X3, KSVD_K, "data", 0)
    (st, counts_step) = counted(lambda: sharded_ksvd_step(slots(4), T=T)(
        X3, D0))
    rD, rG = ksvd_train_step(X3, D0, T=T)
    step_d = float((st[0].gather() - rD).abs().max())
    step_g = float((st[1].gather() - rG).abs().max())
    check(step_d <= 1e-5 and step_g <= 1e-4,
          f"(s3) sharded step D {step_d}, Gamma {step_g}")
    # atom-sharded coding: on well-posed signals at config 2's widths (on
    # the patches OMP's near-ties follow each product's rounding)
    D5, X5 = make_problem(np.random.default_rng(12), 64, KSVD_K, KSVD_N, T)
    D5, X5 = torch.as_tensor(D5, device=dev), torch.as_tensor(X5, device=dev)
    mesh22 = slots(2, 2)
    sm = sharded_ksvd_step(mesh22, T=T, model_shard_atoms=True)(X5, D5)
    mD, mG = ksvd_train_step(X5, D5, T=T)
    model_d = float((sm[0].gather() - mD).abs().max())
    model_g = float((sm[1].gather() - mG).abs().max())
    check(model_d <= 1e-5 and model_g <= 1e-4,
          f"(s3) model_shard_atoms step D {model_d}, Gamma {model_g}")
    cfg2 = lt.KSVDConfig(K=KSVD_K, T=T, n_iter=RUN_KSVD_ITERS)
    (fit, counts_fit) = counted(lambda: lt.KSVDLearner(
        cfg2, mesh=slots(4)).fit(X3, D0))
    base = lt.KSVDLearner(cfg2).fit(X3, D0)
    fit_d = float((fit.D_ - base.D_).abs().max())
    fit_g = float((fit.Gamma_ - base.Gamma_).abs().max())
    check(fit_d <= 2e-4 and fit_g <= 2e-3,
          f"(s3) KSVDLearner(mesh=) D {fit_d}, Gamma {fit_g}")
    ms_fit = cuda_ms(torch, lambda: lt.KSVDLearner(cfg2, mesh=slots(4)).fit(
        X3, D0), reps=1)
    ms_base = cuda_ms(torch, lambda: lt.KSVDLearner(cfg2).fit(X3, D0),
                      reps=1)
    out["s3"] = {"step_D": step_d, "step_Gamma": step_g,
                 "model_step_D": model_d, "model_step_Gamma": model_g,
                 "fit_D": fit_d, "fit_Gamma": fit_g, "fit_s": ms_fit / 1e3,
                 "unsharded_fit_s": ms_base / 1e3,
                 "launches_step": counts_step, "launches_fit": counts_fit,
                 "seconds": time.perf_counter() - t_s}
    print(f"[{card}] (s3) K-SVD K={KSVD_K} T={T} N={KSVD_N}: sharded step "
          f"(data=4) against ksvd_train_step D {step_d:.2e}, Gamma "
          f"{step_g:.2e}; model_shard_atoms (2x2) on well-posed signals D "
          f"{model_d:.2e}, Gamma {model_g:.2e}; KSVDLearner(mesh=data 4) "
          f"{RUN_KSVD_ITERS} iterations D {fit_d:.2e}, Gamma {fit_g:.2e}, "
          f"{ms_fit / 1e3:.3f} s (unsharded {ms_base / 1e3:.3f} s); launches "
          f"step {counts_step}, fit {counts_fit}")
    del X3, X5, D5, st, sm, fit, base

    # --- (s4) the sharded denoise through K3 and K2 per slot
    t_s = time.perf_counter()
    cfg = lt.DenoiseConfig(sigma=SIGMA)
    den_sh = lt.Denoiser(Dd, cfg, mesh=slots(4))
    den_un = lt.Denoiser(Dd, cfg)
    (out_sh, counts) = counted(lambda: den_sh(noisy))
    out_un = den_un(noisy)
    p_sh, p_un = lt.psnr(out_sh, img_d), lt.psnr(out_un, img_d)
    check(abs(p_sh - p_un) <= 0.05, f"(s4) PSNR {p_sh} against {p_un}")
    check(counts["omp_fused_eps"] > 0 and counts["fused_patches"] == 1,
          f"(s4) K2 per slot and one K3 expected, got {counts}")
    # K2 at the shape this route gives it: the call's patches (K3) in its
    # padded blocks, each block's shards of the data slots, T=T_max and the
    # call's eps; against its plain version lane by lane, path (k)'s rule
    Xc, _, _ = fused_patch_pipeline(noisy, cfg.patch, do_dc=True)
    eps4 = cfg.gain * cfg.patch * SIGMA
    nb = math.ceil(Xc.shape[1] / cfg.block)
    Xp = torch.nn.functional.pad(Xc, (0, nb * cfg.block - Xc.shape[1]))
    Ds4 = row_copies(Dd, den_sh.mesh)
    pairs = [dx for b in range(nb) for dx in zip(Ds4, data_shards(
        Xp[:, b * cfg.block:(b + 1) * cfg.block], den_sh.mesh))]
    shards = [x for _, x in pairs]
    kw4 = {"T": cfg.T_max, "eps": eps4, "eps_mode": True}
    got, want = ([f(d, x, **kw4) for d, x in pairs]
                 for f in (omp_fused, omp_fused_reference))
    got, want = (tuple(torch.cat([t.to(dev) for t in fs]) for fs in zip(*r))
                 for r in (got, want))
    held4 = hold_lanes(torch, got, want,
                       torch.cat([x.to(dev) for x in shards], dim=1))
    held4["nsel_agree"] = float((got[3] == want[3]).double().mean())
    held4["max_abs_err"] = float((got[1] - want[1]).abs().max())
    held4["mean_nsel"] = float(got[3].double().mean())
    held4["shards"] = [len(shards), shards[0].shape[1]]
    print(f"[{card}] (s4) K2 on the route's {len(shards)} shards of "
          f"{shards[0].shape[1]} patches (K=256, T={cfg.T_max}, eps={eps4}): "
          f"nsel agree on {held4['nsel_agree']:.6f} of lanes, nsel and "
          f"picks on {held4['agree']:.6f}, mean nsel "
          f"{held4['mean_nsel']:.3f}; max |dgamma| "
          f"{held4['max_abs_err']:.3g} (on agreeing lanes "
          f"{held4['gamma_rel']:.3g} of ||x||)")
    check(held4["nsel_agree"] >= 0.999 and held4["agree"] >= 0.999
          and held4["gamma_rel"] <= 1e-5,
          f"(s4) K2 on the route's shards against its plain version: {held4}")
    del Xc, Xp, pairs, shards, got, want
    # the 1x1 mesh takes the same blocked route without a split: what the
    # route costs apart from what the split costs
    den_one = lt.Denoiser(Dd, cfg, mesh=slots(1))
    ms_sh, ms_un, ms_one = (cuda_ms(torch, lambda: d(noisy), reps=3)
                            for d in (den_sh, den_un, den_one))
    out["s4"] = {"psnr": p_sh, "unsharded_psnr": p_un, "s": ms_sh / 1e3,
                 "unsharded_s": ms_un / 1e3, "one_slot_s": ms_one / 1e3,
                 "k2_shards": held4, "launches": counts,
                 "seconds": time.perf_counter() - t_s}
    print(f"[{card}] (s4) denoise {IMG_SIZE}^2 sigma={SIGMA} K=256 mesh "
          f"data=4: PSNR {p_sh:.4f} dB (unsharded {p_un:.4f}); "
          f"{ms_sh / 1e3:.4f} s an image (unsharded, two-phase route "
          f"{ms_un / 1e3:.4f}; blocked route on one slot "
          f"{ms_one / 1e3:.4f}); launches {counts}")

    # --- (s5) sharded online learning at config 4's widths
    t_s = time.perf_counter()
    X4, _ = online_problem()
    cfg4 = lt.OnlineDLConfig(K=K4, lam=LAM, batch_size=ODL_BS,
                             chunk_batches=2)
    X4 = torch.as_tensor(X4[:, :2 * ODL_BS], device=dev)
    print(f"path (s5) depth: 2 minibatches of {ODL_BS} (one chunk)")
    t0 = time.perf_counter()
    on_sh = lt.OnlineDictionaryLearner(cfg4, mesh=slots(4)).fit(X4)
    torch.cuda.synchronize()
    s_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_un = lt.OnlineDictionaryLearner(dataclasses.replace(cfg4)).fit(X4)
    torch.cuda.synchronize()
    s_un = time.perf_counter() - t0
    on_d = float((on_sh.D_ - on_un.D_).abs().max())
    check(on_d <= 2e-3, f"(s5) online D {on_d}")
    out["s5"] = {"D": on_d, "s": s_sh, "unsharded_s": s_un,
                 "seconds": time.perf_counter() - t_s}
    print(f"[{card}] (s5) online fit K={K4} batch {ODL_BS} x 2 mesh data=4: "
          f"D within {on_d:.2e} of the unsharded fit; {s_sh:.3f} s "
          f"(unsharded {s_un:.3f} s)")
    check(launches["omp_fused_t"] > 0 and launches["omp_fused_eps"] > 0
          and launches["fused_patches"] > 0 and launches["gram"] > 0,
          f"path (s): K1, K2, K3 and gram expected, got {launches}")
    print("path (s) seconds: " + ", ".join(
        f"{k} {out[k]['seconds'] if k != 's1' else out['s1_seconds']:.1f}"
        for k in ("s1", "s2", "s3", "s4", "s5")))
    return launches, out


def planted_problem(rng, p, K, N, s):
    """Unit-norm Gaussian dictionary and signals that are noisy s-sparse
    combinations of its atoms, as make_problem makes them, without the
    dense (K, N) code matrix (make_problem's would be 4 GB at path (t)'s
    shape)."""
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    idx = np.stack([rng.choice(K, s, replace=False) for _ in range(N)])
    X = np.einsum("pnt,nt->pn", D[:, idx], rng.standard_normal((N, s)))
    X += 0.01 * rng.standard_normal((p, N))
    return D.astype(np.float32), X.astype(np.float32)


def spread_problem(rng, p, K, N, T):
    """Planted signals whose lanes finish at spread-out steps in eps mode
    (eps 0.1): lane n is a combination of n % (T + 1) atoms with Gaussian
    weights, plus noise of 0.01 a coordinate (||noise||^2 about 0.0064 at
    p=64), so a lane with no atom is done on entry and the others once
    they hold their atoms."""
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    X = 0.01 * rng.standard_normal((p, N))
    for s in range(1, T + 1):
        lanes = np.arange(s, N, T + 1)
        idx = np.stack([rng.choice(K, s, replace=False) for _ in lanes])
        X[:, lanes] += np.einsum("pnt,nt->pn", D[:, idx],
                                 rng.standard_normal((len(lanes), s)))
    return D.astype(np.float32), X.astype(np.float32)


def ptxas_report(log, pattern):
    """ptxas's registers and spills for each compiled instance whose
    mangled name matches `pattern`, from the build's `-Xptxas -v` lines:
    {name: {"registers": n, "spill_stores": bytes, "spill_loads":
    bytes}}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def steps_run(torch, res, T, eps=None):
    """The lanes that ran each step's selection in a fused OMP result
    (idx, gamma, err, nsel): those that took an atom there, and those that
    froze there (short of T without reaching eps)."""
    nsel, err = res[3], res[2]
    done = (err <= eps * eps if eps is not None
            else torch.zeros_like(nsel, dtype=torch.bool))
    froze = (nsel < T) & ~done
    return [int(((nsel > t) | ((nsel == t) & froze)).sum()) for t in range(T)]


def residual_phases(torch, fn, reps=REPS):
    """Device time of one residual-form call (cuda_omp.omp_residual_fused)
    by phase: CUDA events around each launch of the kernel library (init,
    selection, update), summed by phase; the median of `reps` warm calls
    for each phase."""
    from lyssandra_tpu_torch import _build

    lib = _build.load()
    phases = {"lyssa_omp_residual_init": "init",
              "lyssa_select_rows": "selection",
              "lyssa_omp_residual_step": "update"}
    marks = []

    class Timed:
        def __getattr__(self, name):
            real = getattr(lib, name)
            if name not in phases:
                return real

            def call(*args):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                code = real(*args)
                stop.record()
                marks.append((phases[name], start, stop))
                return code
            return call

    fn()
    load = _build.load
    _build.load = lambda: Timed()
    try:
        runs = []
        for _ in range(reps):
            marks.clear()
            fn()
            torch.cuda.synchronize()
            run = dict.fromkeys(phases.values(), 0.0)
            for phase, start, stop in marks:
                run[phase] += start.elapsed_time(stop)
            runs.append(run)
    finally:
        _build.load = load
    return {ph: statistics.median(r[ph] for r in runs)
            for ph in phases.values()}


def library_select_ms(torch, D, counts):
    """The selection as one PyTorch call a step, argmax(abs(r @ D)) over
    r (n, p), at each step's count n of running lanes, summed over the
    steps (a yardstick the port never calls)."""
    times, total = {}, 0.0
    for n in counts:
        if n and n not in times:
            r = torch.randn((n, D.shape[0]), device=D.device)
            times[n] = cuda_ms(torch, lambda: torch.argmax(
                torch.abs(r @ D), dim=1), reps=3)
            del r
        total += times.get(n, 0.0)
    return total


def large_k_paths(torch, lt, dev, card):
    """Paths (t) and (n2): K1/K2 above the Gram form's shared-memory cap,
    in the residual form (csrc/omp_residual.cu with csrc/select.cu's
    float32 selection on the running lanes).  (t) at p=64, K=16,384, T=8,
    N=32,768 against the plain version on Gaussian and planted signals in
    both modes and on a mix whose lanes finish at spread-out steps, timed
    by phase beside the library's selection, then a grid of (p, K, T)
    through batch_omp and omp whose launch counts name the route; (n2) SRC
    with 16,800 training samples.  Returns (the launches of the grid,
    those of (n2), one JSON-able dict of results, the K1-L and K2-L rows'
    numbers)."""
    from lyssandra_tpu_torch import _build
    from lyssandra_tpu_torch.ops import cuda_omp
    from lyssandra_tpu_torch.ops.cuda_omp import (
        kernel_supports, omp_fused_reference, omp_residual_fused,
        residual_chunk_lanes, residual_splits, residual_step_smem_bytes,
    )
    from lyssandra_tpu_torch.solvers.greedy import omp_route

    out, rows = {}, {}
    t_s = time.perf_counter()
    p, K_, T_, N = LK_P, LK_K, LK_T, LK_N
    rng = np.random.default_rng(21)
    Dg = rng.standard_normal((p, K_))
    Dg /= np.linalg.norm(Dg, axis=0, keepdims=True)
    Dg = torch.as_tensor(Dg.astype(np.float32), device=dev)
    Xg = torch.as_tensor(rng.standard_normal((p, N)).astype(np.float32),
                         device=dev)
    Xge = Xg.clone()
    Xge[:, ::2] *= 0.05                    # half the lanes exit early
    Dp, Xp = (torch.as_tensor(a, device=dev)
              for a in planted_problem(rng, p, K_, N, T_))
    Xpe = Xp.clone()
    Xpe[:, ::2] *= 0.05
    chunk = residual_chunk_lanes(p, T_)
    splits = residual_splits(p, K_, min(N, chunk),
                             cuda_omp._sm_count(dev.index or 0))
    cases = (("K1-L", "gaussian", Dg, Xg, {"T": T_}),
             ("K2-L", "gaussian", Dg, Xge, {"T": T_, "eps": LK_EPS,
                                            "eps_mode": True}),
             ("K1-L", "planted", Dp, Xp, {"T": T_}),
             ("K2-L", "planted", Dp, Xpe, {"T": T_, "eps": LK_EPS_PLANTED,
                                           "eps_mode": True}))
    held = {}
    for name, data, D, X, kw in cases:
        got = omp_residual_fused(D, X, **kw)
        want = omp_fused_reference(D, X, **kw)
        h = hold_lanes(torch, got, want, X)
        h["mean_nsel"] = float(got[3].double().mean())
        h["max_abs_err"] = float((got[1] - want[1]).abs().max())
        held[f"{name} {data}"] = h
        print(f"[{card}] (t) {name} {data} p={p} K={K_} T={T_} N={N} "
              f"{kw.get('eps', '')}: idx and nsel equal on "
              f"{h['agree']:.6f} of lanes; there max |dgamma| "
              f"{h['gamma_abs']:.3g}, |derr|/err {h['err_rtol']:.3g}; mean "
              f"nsel {h['mean_nsel']:.3f}")
        need = 1.0 if data == "planted" else 0.999
        check(h["agree"] >= need and h["gamma_abs"] <= 1e-4
              and h["err_rtol"] <= 1e-4,
              f"(t) {name} on {data} signals against its plain version: {h}")
        if data == "gaussian":
            # the least time: X and D read once, the outputs written once;
            # the selection product over the steps the lanes ran, 2 p K
            # flops a lane and step (the rest is O(p T^2) a lane)
            steps = float(got[3].double().sum())
            eps = kw.get("eps")
            frozen = int((got[3] < T_).sum()) if eps is None else 0
            bnd = bound_ms(4 * (p * N + p * K_ + 2 * N * T_ + 2 * N),
                           2 * p * K_ * steps, PEAK_F32)
            ms = cuda_ms(torch, lambda: omp_residual_fused(D, X, **kw))
            plain = cuda_ms(torch, lambda: omp_fused_reference(D, X, **kw))
            phases = residual_phases(torch, lambda: omp_residual_fused(
                D, X, **kw))
            ran = steps_run(torch, got, T_, eps)
            library = library_select_ms(torch, D, ran)
            _, syncs = count_syncs(torch, lambda: omp_residual_fused(
                D, X, **kw))
            check(syncs <= 1, f"(t) {name}: {syncs} host syncs a call")
            # D streams through shared memory once per selection block
            # (128 running lanes, one atom range) and step
            d_bytes = 4.0 * p * K_ * sum(-(-n // 128) for n in ran)
            sel_ops = 2.0 * p * K_ * sum(ran)
            rows[name] = {
                "max_abs_err": h["max_abs_err"], "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library, "phases_ms": phases,
                "host_syncs": syncs, "chunk_lanes": chunk,
                "selection_splits": list(splits), "lanes_per_step": ran,
                "mean_nsel": h["mean_nsel"], "lanes_frozen": frozen,
                "d_bytes_streamed": d_bytes,
                "d_stream_tb_per_s": d_bytes / (phases["selection"] * 1e-3)
                / 1e12,
                "selection_tflop_per_s": sel_ops
                / (phases["selection"] * 1e-3) / 1e12,
                "tflop_per_s": 2 * p * K_ * steps / (ms * 1e-3) / 1e12}
            print(f"[{card}] (t) {name} p={p} K={K_} T={T_} N={N}: kernel "
                  f"{ms:.3f} ms (init {phases['init']:.4f}, selection "
                  f"{phases['selection']:.3f}, update {phases['update']:.3f}"
                  f" ms), plain {plain:.3f} ms, library selection "
                  f"{library:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, "
                  f"{bnd[0] / ms:.3f} of the kernel's time); lanes a step "
                  f"{ran}; atoms in {splits[0]} ranges of {splits[1]} tiles; "
                  f"D streamed {d_bytes / 1e9:.2f} GB "
                  f"({rows[name]['d_stream_tb_per_s']:.2f} TB/s in the "
                  f"selection), selection "
                  f"{rows[name]['selection_tflop_per_s']:.2f} TFLOP/s; "
                  f"{syncs} host syncs a call")
    check(rows["K2-L"]["ms"] <= 0.8 * rows["K1-L"]["ms"],
          f"(t) K2-L {rows['K2-L']['ms']} ms is not 20% below K1-L's "
          f"{rows['K1-L']['ms']} ms: its work does not follow its lanes")
    # K2-L on lanes that finish at spread-out steps (0 to 8 atoms, eps
    # 0.1), and on the same lanes scaled so that every one is done on entry
    Dm, Xm = (torch.as_tensor(a, device=dev)
              for a in spread_problem(np.random.default_rng(24), p, K_, N,
                                      T_))
    spread = {}
    for what, X in (("spread", Xm), ("all done on entry", 1e-3 * Xm)):
        kw = {"T": T_, "eps": 0.1, "eps_mode": True}
        got = omp_residual_fused(Dm, X, **kw)
        h = hold_lanes(torch, got, omp_fused_reference(Dm, X, **kw), X)
        h["lanes_per_step"] = steps_run(torch, got, T_, kw["eps"])
        h["ms"] = cuda_ms(torch, lambda: omp_residual_fused(Dm, X, **kw))
        spread[what] = h
        print(f"[{card}] (t) K2-L {what} p={p} K={K_} T={T_} N={N} eps=0.1: "
              f"idx and nsel equal on {h['agree']:.6f} of lanes, max "
              f"|dgamma| {h['gamma_abs']:.3g}, |derr|/err "
              f"{h['err_rtol']:.3g} there; lanes a step "
              f"{h['lanes_per_step']}; {h['ms']:.3f} ms")
        check(h["agree"] >= (0.999 if what == "spread" else 1.0)
              and h["gamma_abs"] <= 1e-4 and h["err_rtol"] <= 1e-4,
              f"(t) K2-L on the {what} mix against its plain version: {h}")
    check(spread["all done on entry"]["lanes_per_step"][0] == 0
          and len(set(spread["spread"]["lanes_per_step"])) == T_,
          f"(t) K2-L mixes: lanes a step {spread}")
    del Dm, Xm
    # the step kernel's shared memory against the wrapper's formula
    lib = _build.load()
    for st in (T_, SRC_T, 32, 48, 100):
        check(lib.lyssa_omp_residual_step_smem_bytes(st)
              == residual_step_smem_bytes(st),
              f"(t) K1-L step shared memory at T={st}: the kernel and "
              f"residual_step_smem_bytes disagree")
    # the envelope's widest factors: p=512, T=48 and p=64, T=100 (lanes
    # that reach eps in a few steps: equal on every lane; 48 steps at
    # p=512: noise-level picks, >= 99% of lanes), then p=64, T=100 on 7,000
    # lanes, more than one chunk
    lane_cases = []
    for sp, st, n, modes in ((512, 48, 200, ("eps", "T")),
                             (64, 100, 200, ("eps",)),
                             (64, 100, 7000, ("eps",))):
        Dv, Xv = (torch.as_tensor(a, device=dev) for a in planted_problem(
            np.random.default_rng(sp + st + n), sp, 13000, n, 4))
        Xv[:, ::2] *= 0.05
        for mode in modes:
            kw = ({"T": st, "eps": LK_EPS, "eps_mode": True} if mode == "eps"
                  else {"T": st})
            h = hold_lanes(torch, omp_residual_fused(Dv, Xv, **kw),
                           omp_fused_reference(Dv, Xv, **kw), Xv)
            h.update(p=sp, T=st, N=n, mode=mode,
                     chunk_lanes=residual_chunk_lanes(sp, st))
            lane_cases.append(h)
            print(f"[{card}] (t) K1-L/K2-L p={sp} K=13000 T={st} N={n} "
                  f"{mode} mode, chunks of {h['chunk_lanes']} lanes: idx "
                  f"and nsel equal on {h['agree']:.4f} of lanes, max "
                  f"|dgamma| {h['gamma_abs']:.3g} there")
            check(h["agree"] >= (1.0 if mode == "eps" else 0.99)
                  and h["gamma_abs"] <= 1e-4,
                  f"(t) p={sp} T={st} N={n} {mode} mode: {h}")
    # a call's launches: one init (a chunk), then a selection and an update
    # a step; no product launch
    lt.reset_launch_counts()
    omp_residual_fused(Dg, Xg, T=T_)
    per_call = lt.launch_counts()
    want = {"omp_residual_t": 1, "omp_residual_select": T_,
            "omp_residual_update": T_}
    check(per_call == {k: want.get(k, 0) for k in per_call},
          f"(t) a K1-L call's launches {per_call}, not {want}")
    out["t"] = {"held": held, "rows": rows, "spread": spread,
                "lane_cases": lane_cases}
    del Dg, Xg, Xge, Dp, Xp, Xpe, got, want

    # --- the grid: which kernel each batch_omp / omp call takes
    grid, launches_t = [], None
    rng = np.random.default_rng(22)
    for gp in LK_GRID_P:
        for gk in LK_GRID_K:
            D = rng.standard_normal((gp, gk)).astype(np.float32)
            D /= np.linalg.norm(D, axis=0, keepdims=True)
            D = torch.as_tensor(D, device=dev)
            X = torch.as_tensor(rng.standard_normal(
                (gp, LK_GRID_N)).astype(np.float32), device=dev)
            Xe = X.clone()
            Xe[:, ::2] *= 0.05
            eps = LK_EPS * math.sqrt(gp / p)
            for gt in LK_GRID_T:
                route = "gram" if kernel_supports(gp, gk, gt) else "residual"
                torch.cuda.synchronize()
                lt.reset_launch_counts()
                t0 = time.perf_counter()
                rb = lt.batch_omp(D, X, gt, dense=False)
                ro = lt.omp(D, Xe, gt, eps=eps, dense=False)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                counts = lt.launch_counts()
                launches_t = counts if launches_t is None else {
                    k: launches_t[k] + counts[k] for k in launches_t}
                want = ({"omp_fused_t": 1, "omp_fused_eps": 1, "gram": 2}
                        if route == "gram" else
                        {"omp_residual_t": 1, "omp_residual_eps": 1,
                         "omp_residual_select": 2 * gt,
                         "omp_residual_update": 2 * gt})
                check(counts == {k: want.get(k, 0) for k in counts},
                      f"(t) grid p={gp} K={gk} T={gt}: route {route}, "
                      f"launches {counts}")
                hb = hold_lanes(torch, tuple(rb), omp_fused_reference(
                    D, X, T=gt), X)
                ho = hold_lanes(torch, tuple(ro), omp_fused_reference(
                    D, Xe, T=gt, eps=eps, eps_mode=True), Xe)
                check(all(bool(torch.isfinite(r.gamma).all())
                          for r in (rb, ro)),
                      f"(t) grid p={gp} K={gk} T={gt}: codes not finite")
                if route == "residual":
                    check(hb["agree"] >= 0.99 and ho["agree"] >= 0.99,
                          f"(t) grid p={gp} K={gk} T={gt}: K1-L {hb}, "
                          f"K2-L {ho}")
                grid.append({"p": gp, "K": gk, "T": gt, "route": route,
                             "launches": counts, "s": sec,
                             "agree_t": hb["agree"], "agree_eps": ho["agree"],
                             "mean_nsel_eps": float(ro.nsel.double().mean())})
                print(f"[{card}] (t) grid p={gp} K={gk} T={gt} "
                      f"N={LK_GRID_N}: {route} ({counts['omp_fused_t']} K1, "
                      f"{counts['omp_fused_eps']} K2, "
                      f"{counts['omp_residual_t']} K1-L, "
                      f"{counts['omp_residual_eps']} K2-L calls with "
                      f"{counts['omp_residual_select']} selection and "
                      f"{counts['omp_residual_update']} update launches, "
                      f"{counts['gram']} gram); picks agree with the plain "
                      f"version on {hb['agree']:.4f} (T-mode), "
                      f"{ho['agree']:.4f} (eps={eps:.3f}); {sec:.3f} s")
            del D, X, Xe
    out["t_grid"] = grid
    out["t_seconds"] = time.perf_counter() - t_s

    # --- (n2) SRC above the cap: 16,800 training samples of the stand-in
    t_s = time.perf_counter()
    Xtr, ytr, Xte, yte = digits_problem(n=SRC_LARGE_N)
    Xtr, Xte = torch.as_tensor(Xtr, device=dev), torch.as_tensor(Xte,
                                                                 device=dev)
    check(omp_route("cuda", Xtr.dtype, Xte.dtype, "f32", Xtr.shape[0],
                    Xtr.shape[1], SRC_T) == "residual",
          f"(n2) K={Xtr.shape[1]} must take K1-L")

    def src_run():
        r = {}
        torch.cuda.synchronize()
        lt.reset_launch_counts()
        t0 = time.perf_counter()
        src = lt.SRCClassifier(T=SRC_T).fit(Xtr, ytr)
        torch.cuda.synchronize()
        r["fit_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r["accuracy"] = src.score(Xte, yte)
        r["predict_s"] = time.perf_counter() - t0
        r["launches"] = lt.launch_counts()
        return r, src

    kernel, src = src_run()
    want = {"omp_residual_t": 1, "omp_residual_select": SRC_T,
            "omp_residual_update": SRC_T}
    check(kernel["launches"] == {k: want.get(k, 0)
                                 for k in kernel["launches"]},
          f"(n2) SRC predict: one K1-L call ({want}) expected, got "
          f"{kernel['launches']}")
    predict_ms = cuda_ms(torch, lambda: src.predict(Xte), reps=3)
    real = cuda_omp.omp_residual_fused
    cuda_omp.omp_residual_fused = cuda_omp.omp_fused_reference
    try:
        plain, _ = src_run()
        plain_predict_ms = cuda_ms(torch, lambda: src.predict(Xte), reps=3)
    finally:
        cuda_omp.omp_residual_fused = real
    check(sum(plain["launches"].values()) == 0,
          f"(n2) the plain route launched {plain['launches']}")
    Xn = Xte / torch.linalg.norm(Xte, dim=0, keepdim=True).clamp_min(1e-12)
    lanes_n2 = hold_lanes(torch, omp_residual_fused(src.D_, Xn, T=SRC_T),
                          omp_fused_reference(src.D_, Xn, T=SRC_T), Xn)
    print(f"[{card}] (n2) SRC T={SRC_T} on digits_problem(n={SRC_LARGE_N}): "
          f"{Xtr.shape[1]} training atoms, {Xte.shape[1]} test images; fit "
          f"{kernel['fit_s']:.4f} s, predict {kernel['predict_s']:.4f} s "
          f"(warm {predict_ms:.3f} ms; plain route {plain_predict_ms:.3f} "
          f"ms), accuracy {kernel['accuracy']:.4f} (plain route "
          f"{plain['accuracy']:.4f}); K1-L against its plain version on "
          f"SRC's coding: {lanes_n2['agree']:.6f} of lanes agree (not "
          f"gated: the stand-in's atoms are coherent); launches "
          f"{kernel['launches']}")
    check(abs(kernel["accuracy"] - plain["accuracy"]) <= 0.02,
          f"(n2) SRC accuracy {kernel['accuracy']} against {plain['accuracy']}"
          f" on the plain route")
    out["n2"] = {"n_train": Xtr.shape[1], "n_test": Xte.shape[1],
                 "T": SRC_T, "kernel": kernel, "plain": plain,
                 "predict_ms": predict_ms, "plain_predict_ms":
                 plain_predict_ms, "k1l_lanes": lanes_n2,
                 "seconds": time.perf_counter() - t_s}
    del Xtr, Xte, Xn, src
    return launches_t, kernel["launches"], out, rows


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
    from lyssandra_tpu_torch.apps import inpaint
    from lyssandra_tpu_torch.apps.denoise import Denoiser
    from lyssandra_tpu_torch.ops.cuda_fs import (
        fs_cold_fused, fs_cold_fused_reference,
    )
    from lyssandra_tpu_torch.ops.cuda_fs_scan import (
        fs_scan_fused, fs_scan_fused_reference,
        lane_smem_bytes as scan_smem_bytes,
    )
    from lyssandra_tpu_torch.ops.cuda_gram import gram, gram_reference
    from lyssandra_tpu_torch.ops.cuda_group import (
        _atom_ids, group_omp_fused, group_omp_fused_reference,
        slot_dictionary, slot_table,
    )
    from lyssandra_tpu_torch.ops.cuda_omp import (
        block_lanes, block_smem_bytes, omp_fused, omp_fused_reference,
    )
    from lyssandra_tpu_torch.ops.cuda_patches import (
        fused_patch_pipeline_p1, fused_patch_pipeline_reference,
    )
    from lyssandra_tpu_torch.ops.cuda_select import (
        select_abs_argmax, select_abs_argmax_reference,
        smem_bytes as select_smem_bytes,
    )
    from lyssandra_tpu_torch.solvers.greedy import _omp_impl
    from lyssandra_tpu_torch.ops import cuda_fs
    from lyssandra_tpu_torch.solvers.lasso import (
        _fs_scan_supported, host_syncs,
    )
    from lyssandra_tpu_torch.ops.dictionaries import dct_dictionary_color
    from lyssandra_tpu_torch.utils.datasets import (
        synthetic_color_image, synthetic_image,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # --- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
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
    D3, X3 = D, X            # the well-posed problem, again in path (e)

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
    NB = Xb.shape[1]
    sel = torch.arange(T, device=dev)[None, :] < got[3][:, None]
    k1_bound = bound_ms(4 * (P * NB + P * K + 2 * NB * T + 2 * NB),
                        gram_omp_flops(torch, P, K, got[3],
                                       distinct_atoms(torch, got[0], sel)),
                        PEAK_F32)
    k1_ms = cuda_ms(torch, lambda: omp_fused(Db, Xb, T=T))
    k1_plain_ms = cuda_ms(torch, lambda: omp_fused_reference(Db, Xb, T=T))
    # the wrapper's parts: G = D^T D (one symmetric product launch) and
    # D^T; and the kernel at T=1, which is the alpha0 product, one
    # selection and the set-up, without Gram rows
    k1_parts = {
        "G = D^T D": cuda_ms(torch, lambda: gram(Db, Db, symmetric=True)),
        "D^T": cuda_ms(torch, lambda: Db.T.contiguous()),
        "T=1": cuda_ms(torch, lambda: omp_fused(Db, Xb, T=1)),
    }
    k1_lanes = block_lanes(P, K, T)
    # what bounds it: the steps after the first read one Gram row (4 K
    # bytes) per selected atom, sum_{t < nsel} t rows a lane; the rest is
    # mostly the alpha0 product (2 p K flops a lane)
    rows = float((got[3].double() * (got[3].double() - 1) / 2).sum())
    k1_row_rate = 4 * K * rows / ((k1_ms - k1_parts["T=1"]) * 1e-3)
    k1_alpha0_rate = 2 * P * K * NB / (k1_parts["T=1"] * 1e-3)
    lib = _build.load()
    for shape in ((P, K, T), (P, 256, 10), (768, 256, 10), (21, 99, 3)):
        lanes = block_lanes(*shape)
        check(lib.lyssa_omp_fused_smem_bytes(*shape, lanes)
              == block_smem_bytes(*shape, lanes),
              f"K1 shared memory at {shape}: the kernel and block_smem_bytes "
              f"disagree")
    print(f"K1 p={P} K={K} T={T} N={NB}: kernel {k1_ms:.3f} ms (G build "
          f"{k1_parts['G = D^T D']:.4f} ms = "
          f"{k1_parts['G = D^T D'] / k1_ms:.4f} of it; D^T "
          f"{k1_parts['D^T']:.4f} ms; at T=1 {k1_parts['T=1']:.3f} ms), "
          f"plain {k1_plain_ms:.3f} ms; {k1_lanes} lanes a block "
          f"({block_smem_bytes(P, K, T, k1_lanes)} bytes of shared memory); "
          f"Gram rows read at {k1_row_rate / 1e12:.3f} TB/s after the first "
          f"step, alpha0 at {k1_alpha0_rate / 1e12:.3f} TFLOP/s (T=1)")
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
    NP = Xc.shape[1]
    sel = torch.arange(10, device=dev)[None, :] < got[3][:, None]
    k2_bound = bound_ms(4 * (P * NP + P * 256 + 2 * NP * 10 + 2 * NP),
                        gram_omp_flops(torch, P, 256, got[3],
                                       distinct_atoms(torch, got[0], sel)),
                        PEAK_F32)
    k2_ms = cuda_ms(torch, lambda: omp_fused(
        Dd, Xc, T=10, eps=eps, eps_mode=True))
    k2_plain_ms = cuda_ms(torch, lambda: omp_fused_reference(
        Dd, Xc, T=10, eps=eps, eps_mode=True))
    k2_lanes = block_lanes(P, 256, 10)
    print(f"K2 p={P} K=256 T=10 N={NP}: kernel {k2_ms:.3f} ms, plain "
          f"{k2_plain_ms:.3f} ms; {k2_lanes} lanes a block")
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
    # the generic path (p != 8): p=7, DC removal / + whitening
    rng = np.random.default_rng(11)
    whiten7 = (dt(0.1 * rng.standard_normal((49, 49)).astype(np.float32)),
               dt(rng.standard_normal(49).astype(np.float32)))
    k3_cases = (
        (8, "dc", {"do_dc": True}),
        (8, "dc+norm", {"do_dc": True, "do_norm": True}),
        (8, "dc+norm+whiten", {"do_dc": True, "do_norm": True,
                               "whiten": whiten}),
        (7, "dc", {"do_dc": True}),
        (7, "dc+norm+whiten", {"do_dc": True, "do_norm": True,
                               "whiten": whiten7}))
    k3_times = []
    for p_, what, kw in k3_cases:
        if p_ != 8:
            got = fused_patch_pipeline_p1(noisy, p_, **kw)
            want = fused_patch_pipeline_reference(noisy, p_, **kw)
            errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            check(max(errs) <= 1e-4, f"K3 p={p_} {what}: {errs}")
            k3_err = max(k3_err, *errs)
            print(f"K3 p={p_} {what}: max |d| X, means, scales = {errs}")
        # image in; patches, means and scales out; a sum and a subtraction
        # per patch element, and 2 p^4 flops a patch for the whitening
        np_ = (IMG_SIZE - p_ + 1) ** 2
        bnd = bound_ms(4 * (IMG_SIZE * IMG_SIZE + (p_ * p_ + 2) * np_),
                       2 * p_ * p_ * np_
                       + (2 * p_ ** 4 * np_ if "whiten" in kw else 0),
                       PEAK_F32)
        ms = cuda_ms(torch, lambda: fused_patch_pipeline_p1(noisy, p_, **kw))
        g_ms = graph_ms(torch, lambda: fused_patch_pipeline_p1(
            noisy, p_, **kw))
        k3_times.append({"variant": what, "p": p_, "ms": ms, "graph_ms": g_ms,
                         "bound_ms": bnd[0], "bound_by": bnd[1]})
        print(f"K3 {IMG_SIZE}^2 p={p_} {what}: kernel {ms:.4f} ms a call, "
              f"{g_ms:.4f} ms in a CUDA graph; bound {bnd[0]:.4f} ms "
              f"({bnd[1]}), {bnd[0] / g_ms:.3f} of it in the graph")
    k3_ms, k3_graph_ms = k3_times[0]["ms"], k3_times[0]["graph_ms"]
    k3_bound = (k3_times[0]["bound_ms"], k3_times[0]["bound_by"])
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
    # a flat image (every patch constant: the centred sum of squares is 0
    # and the scales clamp to eps); patch rows one past the kernel's runs
    # of 256 patches (p=8) and of 64 (whitening at other p); p=150, whose
    # image tile does not fit shared memory (windows read from the image)
    flat = dt(np.full((40, 36), 137.0, np.float32))
    run257 = dt((255.0 * rng.random((20, 257 + 7))).astype(np.float32))
    run65 = dt((255.0 * rng.random((20, 65 + 4))).astype(np.float32))
    big = dt((255.0 * rng.random((160, 170))).astype(np.float32))
    norm = {"do_dc": True, "do_norm": True}
    for name, im, p, kw in (
            ("33x47", odd, 8, norm),
            ("33x47", odd, 5, {**norm, "whiten": (Wm5, off5)}),
            ("flat 40x36", flat, 8, norm),
            ("flat 40x36", flat, 8, {**norm, "whiten": whiten}),
            ("Wp=257", run257, 8, norm),
            ("Wp=65", run65, 5, {**norm, "whiten": (Wm5, off5)}),
            ("160x170", big, 150, {"do_dc": True})):
        got = fused_patch_pipeline_p1(im, p, **kw)
        want = fused_patch_pipeline_reference(im, p, **kw)
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        check(max(errs) <= 1e-4, f"K3 {name} p={p} {sorted(kw)}: {errs}")
        k3_err = max(k3_err, *errs)
        print(f"K3 {name} p={p} {sorted(kw)}: max |d| = {errs}")
    check(tuple(got[0].shape) == (150 * 150, 11 * 21), "K3 p=150 shape")
    got = fused_patch_pipeline_p1(flat, 8, **norm)
    check(bool((got[2] == 1e-8).all()) and bool((got[0] == 0).all()),
          "K3 flat image: scales not clamped to eps or X not 0")
    del got, want, big

    # --- 5g. the product kernel against A.T @ B (K1, K2, K4 and K6 start
    # from it)
    def gram_case(A, B, what, symmetric=False):
        got = gram(A, B, symmetric=symmetric)
        want = gram_reference(A, B)
        torch.cuda.synchronize()
        p_ = A.shape[0]
        u = 2.0 ** -24
        gamma_p = p_ * u / (1.0 - p_ * u)
        scale = torch.outer(A.double().norm(dim=0), B.double().norm(dim=0))
        err = (got.double() - want.double()).abs()
        rel = float((err / scale.clamp_min(1e-30)).max())
        check(tuple(got.shape) == (A.shape[1], B.shape[1])
              and bool((err <= 2.0 * gamma_p * scale).all()),
              f"gram {what}: max error {float(err.max())}, relative to "
              f"||a_i|| ||b_j|| {rel} (limit {2.0 * gamma_p})")
        if symmetric:
            check(torch.equal(got, gram(A, B)),
                  f"gram {what}: one triangle mirrored differs from the full "
                  f"product")
        print(f"gram {what}: max |dC| {float(err.max()):.3g}, relative to "
              f"||a_i|| ||b_j|| {rel:.3g} (limit {2.0 * gamma_p:.3g})"
              + ("; equal to the full product" if symmetric else ""))
        return float(err.max()), rel

    rng = np.random.default_rng(9)
    gram_err = gram_rel = 0.0
    for p_, M_, K_ in ((21, 500, 100), (512, 1000, 130), (576, 2048, 1024),
                       (1, 33, 7), (13, 67, 67)):
        A_ = dt(rng.standard_normal((p_, M_)).astype(np.float32))
        B_ = dt(rng.standard_normal((p_, K_)).astype(np.float32))
        e_, r_ = gram_case(A_, B_, f"ragged p={p_} M={M_} K={K_}")
        gram_err, gram_rel = max(gram_err, e_), max(gram_rel, r_)
        if M_ == K_ or p_ == 576:
            e_, r_ = gram_case(B_, B_, f"ragged symmetric p={p_} K={K_}",
                               symmetric=True)
            gram_err, gram_rel = max(gram_err, e_), max(gram_rel, r_)
    Dc4, Xc4 = config4_problem()
    Dc4, Xc4 = dt(Dc4), dt(Xc4)
    # the slot dictionary of groups of GS consecutive atoms is D itself;
    # K1's G = D^T D is K4's Gp at the bench shape
    gram_shapes = (("K4 alpha0", Xb[:, :16384].contiguous(), Db, False),
                   ("K4 alpha0", Xb[:, :32768].contiguous(), Db, False),
                   ("K4 Gp, K1 G", Db, Db, True),
                   ("K6 alpha0", Xc4[:, :2048].contiguous(), Dc4, False),
                   ("K6 G", Dc4, Dc4, True))
    gram_times = []
    for what, A_, B_, sym in gram_shapes:
        p_, M_, K_ = A_.shape[0], A_.shape[1], B_.shape[1]
        e_, r_ = gram_case(A_, B_, f"{what} p={p_} M={M_} K={K_}",
                           symmetric=sym)
        gram_err, gram_rel = max(gram_err, e_), max(gram_rel, r_)
        ms = cuda_ms(torch, lambda: gram(A_, B_, symmetric=sym))
        plain = cuda_ms(torch, lambda: gram_reference(A_, B_))
        lib_ms = cuda_ms(torch, lambda: torch.mm(A_.t(), B_))
        g_ms = graph_ms(torch, lambda: gram(A_, B_, symmetric=sym))
        g_lib = graph_ms(torch, lambda: torch.mm(A_.t(), B_))
        # A^T A from one triangle: A read once, p K (K + 1) flops, both
        # halves of C written
        bnd = (bound_ms(4 * (p_ * K_ + K_ * K_), p_ * K_ * (K_ + 1),
                        PEAK_F32) if sym else
               bound_ms(4 * (p_ * M_ + p_ * K_ + M_ * K_),
                        2 * p_ * M_ * K_, PEAK_F32))
        gram_times.append({"shape": what, "p": p_, "M": M_, "K": K_,
                           "symmetric": sym,
                           "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                           "graph_ms": g_ms, "library_graph_ms": g_lib,
                           "bound_ms": bnd[0], "bound_by": bnd[1]})
        print(f"gram {what} p={p_} M={M_} K={K_}"
              + (" symmetric" if sym else "")
              + f": kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"{lib_ms:.4f} ms; in a CUDA graph kernel {g_ms:.4f} ms, "
              f"library {g_lib:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")

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
    got, _ = group_case(Db, Xk4, groups, T_GROUP, "K4 Gaussian N=32768",
                        agree_min=0.999)
    # the Gram form over groups, plus the final solve's two refinement
    # rounds (a Gram residual and two triangular solves each, 8 n^2 for
    # n = nsel gs slots)
    sel = (torch.arange(T_GROUP * GS, device=dev)[None, :]
           < GS * got[3][:, None])
    k4_flops = gram_omp_flops(torch, P, K, got[3],
                              distinct_atoms(torch, got[0], sel), gs=GS)
    k4_flops += 8 * GS * GS * float((got[3].double() ** 2).sum())
    k4_bound = bound_ms(
        4 * (P * 32768 + P * K + 32768 * (T_GROUP * GS + T_GROUP + 2)),
        k4_flops, PEAK_F32)
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
    # the wrapper's parts: the slot dictionary, alpha0 and Gp (both rebuilt
    # on every call), and the atom ids; the rest is the kernel and the host
    members, valid, _, _ = slot_table(groups)
    Dp4 = slot_dictionary(Db, members, valid)
    gidx4 = group_omp_fused(Db, Xk4, groups, T_GROUP)[4]
    parts = {"slot dictionary": lambda: slot_dictionary(Db, members, valid),
             "alpha0 = X^T Dp": lambda: gram(Xk4, Dp4),
             "Gp = Dp^T Dp": lambda: gram(Dp4, Dp4),
             "atom ids": lambda: _atom_ids(members, gidx4)}
    part_ms = {k: cuda_ms(torch, f) for k, f in parts.items()}
    print("K4 wrapper N=32768: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in part_ms.items())
        + f"; kernel and host the other {k4_ms - sum(part_ms.values()):.4f} ms")
    del Dp4, gidx4

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
    def fs_case(D, X, lam, tun, what, agree_min=0.999):
        got = fs_cold_fused(D, X, lam=lam, t_unroll=tun)
        want = fs_cold_fused_reference(D, X, lam=lam, t_unroll=tun)
        agree, same = fs_agree(torch, got, want)
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
    Xb4 = Xc4[:, :2048]
    got = fs_cold_fused(Dc4, Xb4, lam=LAM, t_unroll=TUN)
    want = fs_cold_fused_reference(Dc4, Xb4, lam=LAM, t_unroll=TUN)
    want64 = fs_cold_fused_reference(Dc4.double(), Xb4.double(), lam=LAM,
                                     t_unroll=TUN)
    agree, _ = fs_agree(torch, got, want)
    agree64, _ = fs_agree(torch, want64, want)
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
    # 24x24 patches: p sets only the products' work, not the lane's state
    D576, X576 = sparse_problem(rng, 576, K4, 1024, 4)
    D576, X576 = dt(D576), dt(X576)
    check(cuda_fs.takes(D576, X576, TUN), "K6 gate refuses p=576")
    fs_case(D576, X576, LAM, TUN, "envelope p=576 K=1024 Tun=28")
    del D576, X576
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
    # The operations the lanes' steps need at N=2048, in the cheapest form
    # at this shape, the Gram form: A0 = X^T D and the done test (2pK + K)
    # per lane; the Gram columns of the distinct atoms activated (2pK
    # each); per step that a lane runs, with a active atoms after it, the
    # violator search (K), the gradient over the active set and its KKT
    # test (2Ka + 2K) and two refinements of CG on the (a, a) system, each
    # at least a + 2 products of 2a^2.  A lane runs step t while it is not
    # done after t steps, and the cold start at depth t is the first t
    # steps of the run at depth TUN.
    n6 = Xb4.shape[1]
    done6 = (2.0 * (Xb4.T @ Dc4).abs() <= LAM + 1e-12).all(dim=1)
    k6_flops, k6_steps = (2 * P4 * K4 + K4) * n6, 0
    for t in range(1, TUN + 1):
        st = fs_cold_fused(Dc4, Xb4, lam=LAM, t_unroll=t)
        a = st[1][~done6].sum(dim=1).double()
        k6_flops += float((2 * K4 * a + 3 * K4 + 4 * (a + 2) * a * a).sum())
        k6_steps += a.numel()
        done6 = st[5]
    k6_flops += 2 * P4 * K4 * int(torch.unique(st[0]).numel())
    # outputs: idx, mask, theta, gact (13 bytes a slot), gr, done
    k6_bound = bound_ms(4 * (P4 * n6 + P4 * K4 + n6 * K4) + 13 * n6 * TUN + n6,
                        k6_flops, PEAK_F32)
    print(f"K6 N=2048: {k6_steps / n6:.3f} steps per lane on average; "
          f"bound {k6_bound[0]:.4f} ms ({k6_bound[1]})")

    # --- 5d2. the feature-sign search kernel against its plain version
    def scan_case(D, X, what, lam=LAM, **kw):
        got = fs_scan_fused(D, X, lam=lam, **kw)
        want = fs_scan_fused_reference(D, X, lam=lam, **kw)
        fo = lasso_objectives(torch, D, X, got[0], lam)
        fw = lasso_objectives(torch, D, X, want[0], lam)
        gap = (fo - fw) / fw.clamp_min(1e-12)
        # the lanes done at an optimum (an overflowed lane is done too)
        breach = lasso_kkt_lanes(torch, D, X, got[0], lam)[got[1] & ~got[2]]
        kkt_med = float(breach.median()) if breach.numel() else 0.0
        done_eq = float((got[1] == want[1]).float().mean())
        ovf_eq = float((got[2] == want[2]).float().mean())
        print(f"{what}: objective gap median {float(gap.median()):.3g}, max "
              f"{float(gap.max()):.3g}, min {float(gap.min()):.3g}; KKT "
              f"breach median {kkt_med:.3g} on the optimal lanes; done "
              f"{float(got[1].float().mean()):.4f} (plain "
              f"{float(want[1].float().mean()):.4f}), equal on {done_eq:.4f}"
              f", overflow equal on {ovf_eq:.4f}")
        check(float(gap.median()) <= 1e-8 and float(gap.max()) <= 2e-3,
              f"{what}: objective gap {float(gap.median())}, "
              f"{float(gap.max())}")
        check(kkt_med <= 5e-5, f"{what}: KKT breach median {kkt_med}")
        check(done_eq >= 0.99 and ovf_eq >= 0.99,
              f"{what}: done equal on {done_eq}, overflow on {ovf_eq}")
        return got, float(gap.max())

    scan_err = max(scan_case(Dc4, Xc4[:, :n].contiguous(),
                             f"fs_scan config 4 N={n}")[1]
                   for n in (1024, 4096))
    scan_case(Dw, Xw, "fs_scan well-posed p=192 K=1024 N=2048")
    # ragged widths: K below one pass of the gradient and not a multiple of
    # 32 (5d's envelope problems)
    scan_case(dt(Du.astype(np.float32)), dt(Xu.astype(np.float32)),
              "fs_scan envelope p=21 K=100", lam=0.1)
    scan_case(dt(Dp.astype(np.float32)), dt(Xp.astype(np.float32)),
              "fs_scan envelope coherent pair p=24 K=96")
    got, _ = scan_case(Dc4, Xc4[:, :1024], "fs_scan lam=1e3", lam=1e3)
    check(bool(got[1].all()) and not bool(got[0].any()),
          "fs_scan lam=1e3: every lane done on entry with zero codes")
    got, _ = scan_case(Dc4, Xc4[:, :1024], "fs_scan max_iter=3", max_iter=3)
    check(int((got[0] != 0).sum(dim=0).max()) <= 3,
          "fs_scan max_iter=3: more than one atom an iteration")
    got, _ = scan_case(Dc4, Xc4[:, :1024], "fs_scan max_active=4",
                       max_active=4)
    check(bool(got[2].any()) and int((got[0] != 0).sum(dim=0).max()) <= 4,
          "fs_scan max_active=4: no lane overflowed, or one holds > 4")
    try:
        fs_scan_fused(Dc4, Xc4[:, :1024], lam=LAM, max_active=65)
        check(False, "fs_scan max_active=65 did not raise")
    except ValueError as e:
        print(f"fs_scan max_active=65 raises: {e}")
    for k_ in (100, K4, 51867):
        check(lib.lyssa_fs_scan_smem_bytes(k_) == scan_smem_bytes(k_),
              f"fs_scan shared memory at K={k_}: the kernel's "
              f"{lib.lyssa_fs_scan_smem_bytes(k_)}, the wrapper's "
              f"{scan_smem_bytes(k_)}")
    gate = dict(max_active=64, n_activate=1, warm_start=0, cold_unroll=0)
    check(_fs_scan_supported(Dc4, Xc4, **gate)
          and not _fs_scan_supported(Dc4, Xc4, **dict(gate, n_activate=2))
          and not _fs_scan_supported(Dc4, Xc4, **dict(gate, warm_start=4))
          and not _fs_scan_supported(Dc4, Xc4, **dict(gate, cold_unroll=28)),
          "fs_scan gate")
    # its bound: the least work of the solution in the Gram form, alpha0 and
    # the Gram columns of the atoms used, and per lane the gradient and KKT
    # test at its support and one Cholesky solve of its system
    scan_t = {}
    for n in (1024, 4096):
        Xn = Xc4[:, :n].contiguous()
        Gp = fs_scan_fused_reference(Dc4, Xn, lam=LAM)[0]
        c = (Gp != 0).sum(dim=0).double()
        atoms = int((Gp != 0).any(dim=1).sum())
        flops = (2 * P4 * K4 * (n + atoms)
                 + float((2 * K4 * c + 2 * K4 + c ** 3 / 3 + 2 * c * c).sum()))
        bound = bound_ms(4 * (P4 * n + P4 * K4 + K4 * n), flops, PEAK_F32)
        scan_t[n] = {
            "ms": cuda_ms(torch, lambda: fs_scan_fused(Dc4, Xn, lam=LAM)),
            "graph_ms": graph_ms(torch,
                                 lambda: fs_scan_fused(Dc4, Xn, lam=LAM)),
            "plain_ms": cuda_ms(torch, lambda: fs_scan_fused_reference(
                Dc4, Xn, lam=LAM), reps=3),
            "bound_ms": bound[0], "bound_by": bound[1],
            "mean_nnz": float(c.mean())}
        print(f"fs_scan p={P4} K={K4} N={n}: {json.dumps(scan_t[n])}")
    del got, Gp, Xn

    # --- 5e. K7 against its plain version, then its envelope
    r7 = Xb.T.contiguous()               # the 262,144 Gaussian lanes (N, p)

    def score(r, D_, k, bf16):
        """|r_n . d_k| in float64 on the operands the mode rounds."""
        if bf16:
            r, D_ = r.bfloat16(), D_.bfloat16()
        return (r.double() * D_.double().T[k.long()]).sum(dim=1).abs()

    def select_case(r, D_, what, agree_min=0.999):
        errs = []
        for bf16 in (False, True):
            got = select_abs_argmax(r, D_, bf16=bf16)
            want = select_abs_argmax_reference(r, D_, bf16=bf16)
            agree = float((got == want).float().mean())
            gap = float((score(r, D_, got, bf16)
                         - score(r, D_, want, bf16)).abs().max())
            check(agree >= agree_min, f"{what} bf16={bf16}: picks agree on "
                  f"{agree}")
            print(f"{what} bf16={bf16}: picks agree on {agree:.6f} of lanes; "
                  f"max |score gap| between the picks {gap:.3g}")
            errs.append(gap)
        return errs

    k7_err, k7_err_bf16 = select_case(r7, Db, f"K7 Gaussian N={NB}")
    k7_share = float((select_abs_argmax(r7, Db)
                      != select_abs_argmax_reference(r7, Db)).float().mean())
    # exact ties: atom 7 repeats atom 3 and every lane is near atom 3, so
    # both tie at the maximum with bitwise-equal correlations
    Dtie = Db.clone()
    Dtie[:, 7] = Dtie[:, 3]
    rtie = Dtie[:, 3][None, :] + dt((0.02 * np.random.default_rng(7)
                                     .standard_normal((65536, P)))
                                    .astype(np.float32))
    for bf16 in (False, True):
        got = select_abs_argmax(rtie, Dtie, bf16=bf16)
        want = select_abs_argmax_reference(rtie, Dtie, bf16=bf16)
        check(bool((got == 3).all()) and bool((want == 3).all()),
              f"K7 exact ties bf16={bf16}: not the lower index everywhere")
    # atoms 127 and 128 lie in two atom tiles of the kernel
    Dtie[:, 128] = Dtie[:, 127]
    rtie = Dtie[:, 127][None, :] + dt((0.02 * np.random.default_rng(17)
                                       .standard_normal((4099, P)))
                                      .astype(np.float32))
    for bf16 in (False, True):
        got = select_abs_argmax(rtie, Dtie, bf16=bf16)
        want = select_abs_argmax_reference(rtie, Dtie, bf16=bf16)
        check(bool((got == 127).all()) and bool((want == 127).all()),
              f"K7 exact ties across tiles bf16={bf16}: not the lower index")
    print("K7 exact ties N=65536: index 3 on every lane; across two atom "
          "tiles N=4099: index 127 on every lane; f32 and bf16")
    rng = np.random.default_rng(8)
    for p_, K_, N_ in ((5, 100, 1000), (512, 1024, 4099), (64, 1024, 333),
                       (5, 129, 130), (17, 257, 130), (256, 300, 777),
                       (257, 300, 777), (64, 1345, 20000), (48, 2000, 7001)):
        D_ = rng.standard_normal((p_, K_))
        D_ /= np.linalg.norm(D_, axis=0)
        select_case(dt(rng.standard_normal((N_, p_)).astype(np.float32)),
                    dt(D_.astype(np.float32)),
                    f"envelope p={p_} K={K_} N={N_}")
    lib = _build.load()
    for p_, K_ in ((1, 7), (5, 100), (16, 4586), (17, 257), (64, 1024),
                   (64, 1344), (64, 1345), (65, 100), (256, 300), (257, 300),
                   (512, 1024)):
        for bf16 in (0, 1):
            check(lib.lyssa_select_smem_bytes(p_, K_, bf16)
                  == select_smem_bytes(p_, K_, bool(bf16)),
                  f"K7 shared memory at p={p_} K={K_} bf16={bf16}: the "
                  f"kernel and cuda_select disagree")
    try:
        select_abs_argmax(torch.zeros((64, 513), device=dev),
                          torch.zeros((513, 128), device=dev))
        check(False, "K7 at p=513 did not raise")
    except ValueError as e:
        print(f"K7 p=513 raises: {e}")
    # the machine code: the bf16 kernels take their products on the tensor
    # cores (HMMA), the float32 kernels on the fma units (FFMA, no HMMA)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
         str(_build.library_path())],
        capture_output=True, text=True, check=True, timeout=300).stdout
    seen = set()
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        mode = re.search(r"\d(bfr|bf|f32)13select_kernel", name)
        if mode is None:
            continue
        hmma = len(re.findall(r"\bHMMA\b", fn))
        ffma = len(re.findall(r"\bFFMA\b", fn))
        seen.add(mode.group(1))
        check(hmma > 0 if mode.group(1) != "f32" else hmma == 0 and ffma > 0,
              f"K7 {name}: {hmma} HMMA, {ffma} FFMA")
        print(f"K7 SASS {mode.group(1)} {name[-40:]}: {hmma} HMMA, "
              f"{ffma} FFMA")
    check(seen == {"bf", "bfr", "f32"}, f"K7 SASS: kernels seen {seen}")
    del sass

    def k7_kernel(bf16):
        return lambda: select_abs_argmax(r7, Db, bf16=bf16)

    def k7_library(bf16):
        if bf16:
            return lambda: torch.argmax(torch.abs(
                (r7.bfloat16() @ Db.bfloat16()).float()), dim=1)
        return lambda: torch.argmax(torch.abs(r7 @ Db), dim=1)

    k7_ms, k7_bf16_ms = (cuda_ms(torch, k7_kernel(b)) for b in (False, True))
    k7_graph_ms, k7_bf16_graph_ms = (graph_ms(torch, k7_kernel(b))
                                     for b in (False, True))
    k7_plain_ms = cuda_ms(torch, lambda: select_abs_argmax_reference(r7, Db))
    k7_plain_bf16_ms = cuda_ms(torch, lambda: select_abs_argmax_reference(
        r7, Db, bf16=True))
    k7_lib_ms, k7_bf16_lib_ms = (cuda_ms(torch, k7_library(b))
                                 for b in (False, True))
    k7_lib_graph_ms, k7_bf16_lib_graph_ms = (graph_ms(torch, k7_library(b))
                                             for b in (False, True))
    k7_bytes = 4 * (NB * P + P * K + NB)
    k7_bound = bound_ms(k7_bytes, 2 * NB * P * K, PEAK_F32)
    k7_bound_bf16 = bound_ms(k7_bytes, 2 * NB * P * K, PEAK_BF16)
    print(f"K7 p={P} K={K} N={NB}: kernel f32 {k7_ms:.4f} ms a call, "
          f"{k7_graph_ms:.4f} ms in a CUDA graph; bf16 {k7_bf16_ms:.4f}, "
          f"{k7_bf16_graph_ms:.4f}; plain {k7_plain_ms:.4f} ms (bf16 "
          f"{k7_plain_bf16_ms:.4f}); library pair {k7_lib_ms:.4f} ms, "
          f"{k7_lib_graph_ms:.4f} in a graph (bf16 operands "
          f"{k7_bf16_lib_ms:.4f}, {k7_bf16_lib_graph_ms:.4f}); bound "
          f"{k7_bound[0]:.4f} ms ({k7_bound[1]}), bf16 "
          f"{k7_bound_bf16[0]:.4f} ms ({k7_bound_bf16[1]})")
    del Dtie, rtie

    # --- 6. the main paths, each counted on its own
    cfg = lt.DenoiseConfig(sigma=SIGMA)
    denoiser = Denoiser(Dd, cfg)
    lt.reset_launch_counts()
    res = lt.batch_omp(Db, Xb, T=T, dense=False)
    out = denoiser(noisy)
    torch.cuda.synchronize()
    launches = lt.launch_counts()
    print(f"path (a) batch_omp + denoise launches: {launches}")
    # one K1 and one K2 launch, each after its G = D^T D product
    check(launches["omp_fused_t"] == 1 and launches["omp_fused_eps"] == 1
          and launches["gram"] == 2,
          f"path (a): K1, K2 and their product launches {launches}")

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
    check(launches_g["gram"] == 2 * n_blocks,
          f"group encoder launched the product kernel "
          f"{launches_g['gram']} times, not {2 * n_blocks}")
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
    n_blocks = Xb.shape[1] // bomp_enc.block
    check(launches_b["omp_fused_t"] == n_blocks
          and launches_b["gram"] == n_blocks,
          f"bomp encoder launches {launches_b}: {n_blocks} K1 and "
          f"{n_blocks} product launches expected")
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
    check(launches_d["gram"] == 2 * n_blocks,
          f"lasso encoder launched the product kernel "
          f"{launches_d['gram']} times, not {2 * n_blocks}")
    check(tuple(G4.shape) == (K4, N4) and bool(torch.isfinite(G4).all()),
          "lasso encoder codes: shape, finite")
    G4x = lt.SparseEncoder("lasso", {"lam": LAM, "cold_backend": "xla"}
                           ).encode(Xc4, Dc4)

    # Both paths stop at points whose KKT residuals are within the done
    # tolerances (1e-4 on active stationarity); on the near-singular
    # active sets of config 4's data dictionary such points may differ in
    # objective by a few 1e-5.  So: tests/test_lasso.py's tolerance (rtol
    # 1e-4, atol 1e-5) on >= 99.9% of lanes, rtol 1e-3 on every lane.
    o_k = lasso_objectives(torch, Dc4, Xc4, G4, LAM)
    o_x = lasso_objectives(torch, Dc4, Xc4, G4x, LAM)
    gap = (o_k - o_x).abs()
    n_out = int((gap > 1e-5 + 1e-4 * o_x.abs()).sum())
    check(n_out <= N4 // 1000 and bool((gap <= 1e-3 * o_x.abs()).all()),
          f"lasso objective against the plain path: {n_out} lanes beyond "
          f"rtol 1e-4, max gap {float(gap.max())}")
    viol_act, viol_inact = lasso_kkt(torch, Dc4, Xc4, G4, LAM)
    check(viol_act < 1e-3 and viol_inact <= LAM + 1e-3,
          f"lasso KKT: active {viol_act}, inactive {viol_inact}")
    print(f"lasso encoder N={N4}: objective mean {float(o_k.mean()):.6f}, "
          f"max |gap| to the plain path {float(gap.max()):.3g} (max relative "
          f"{float((gap / o_x.clamp_min(1e-12)).max()):.3g}; {n_out} lanes "
          f"beyond rtol 1e-4, atol 1e-5); KKT active {viol_act:.3g}, "
          f"inactive max {viol_inact:.6f} (lam {LAM}); mean nnz "
          f"{float((G4.abs() > 1e-10).sum(dim=0).double().mean()):.3f}")
    del G4x

    # path (e): the residual-form OMP with the fused selection, one K7
    # launch per step
    lt.reset_launch_counts()
    res_e = _omp_impl(Db, Xb, 0.0, T=T, eps_mode=False, fused_select=True)
    torch.cuda.synchronize()
    launches_e = lt.launch_counts()
    print(f"path (e) _omp_impl(fused_select=True) launches: {launches_e}")
    check(launches_e["select_abs_argmax"] == T,
          f"K7 launched {launches_e['select_abs_argmax']} times, not {T}")
    ref_e = _omp_impl(Db, Xb, 0.0, T=T, eps_mode=False)
    agree = float((res_e.idx == ref_e.idx).all(dim=1).float().mean())
    check(agree >= 0.999, f"fused_select idx agreement {agree}")
    print(f"fused_select N={NB}: idx agree with the unfused selection on "
          f"{agree:.6f} of lanes")
    n0 = lt.launch_counts()["select_abs_argmax"]
    wp = _omp_impl(D3, X3, 0.0, T=T, eps_mode=False, fused_select=True)
    wq = _omp_impl(D3, X3, 0.0, T=T, eps_mode=False)
    check(torch.equal(wp.idx, wq.idx) and torch.equal(wp.nsel, wq.nsel),
          "fused_select idx/nsel on the well-posed problem")
    e_err = float((wp.gamma - wq.gamma).abs().max())
    check(e_err <= 1e-4, f"fused_select gamma on the well-posed problem "
          f"{e_err}")
    res_eb = _omp_impl(Db, Xb, 0.0, T=T, eps_mode=False, corr_dtype="bf16",
                       fused_select=True)
    ref_eb = _omp_impl(Db, Xb, 0.0, T=T, eps_mode=False, corr_dtype="bf16")
    agree_b = float((res_eb.idx == ref_eb.idx).all(dim=1).float().mean())
    check(agree_b >= 0.999, f"fused_select bf16 idx agreement {agree_b}")
    n1 = lt.launch_counts()["select_abs_argmax"]
    res_ee = _omp_impl(Dd, Xc, eps, T=10, eps_mode=True, fused_select=True)
    n_eps = lt.launch_counts()["select_abs_argmax"] - n1
    ref_ee = _omp_impl(Dd, Xc, eps, T=10, eps_mode=True)
    agree_ee = float((res_ee.nsel == ref_ee.nsel).float().mean())
    check(1 <= n_eps <= 10 and agree_ee >= 0.999,
          f"fused_select eps mode: {n_eps} launches, nsel agree {agree_ee}")
    check(n1 - n0 == 2 * T, "fused_select launches, well-posed and bf16")
    print(f"fused_select well-posed N=32768: idx, nsel equal, max |dgamma| "
          f"{e_err:.3g}; bf16 idx agree on {agree_b:.6f} of lanes; eps mode "
          f"on the denoise patches: {n_eps} launches, nsel agree on "
          f"{agree_ee:.6f} of lanes")
    del res_e, ref_e, res_eb, ref_eb, res_ee, ref_ee, wp, wq

    # path (f): the nn_omp encoder on the solver sweep's signals
    Ds, Xs = sweep_problem()
    Ds, Xs = dt(Ds), dt(np.abs(Xs))
    nn_enc = lt.SparseEncoder("nn_omp", {"T": T})
    lt.reset_launch_counts()
    nres = nn_enc.encode(Xs, Ds, dense=False)
    torch.cuda.synchronize()
    launches_f = lt.launch_counts()
    print(f"path (f) SparseEncoder('nn_omp') launches: {launches_f}")
    check(tuple(nres.idx.shape) == (N_SWEEP, T)
          and bool(torch.isfinite(nres.gamma).all())
          and bool((nres.gamma >= 0).all()), "nn_omp codes: shape, >= 0")
    # the scan and unrolled forms on one block (tests/test_greedy.py's
    # rule: nsel and idx equal where the residual stays above 1e-6)
    blk = Xs[:, :nn_enc.block]
    a = lt.nn_omp(Ds, blk, T, dense=False, unroll=False)
    b = lt.nn_omp(Ds, blk, T, dense=False, unroll=True)
    generic = a.err > 1e-6
    check(torch.equal(a.nsel[generic], b.nsel[generic])
          and torch.equal(a.idx[generic], b.idx[generic]),
          "nn_omp scan and unrolled forms select differently")
    nn_err = float((a.dense(K) - b.dense(K)).abs().max())
    nn_derr = float((a.err - b.err).abs().max())
    check(nn_err <= 2e-5 and nn_derr <= 2e-4,
          f"nn_omp forms: codes {nn_err}, err {nn_derr}")
    print(f"nn_omp N={N_SWEEP}: codes >= 0, mean nsel "
          f"{float(nres.nsel.float().mean()):.3f}; scan and unrolled forms "
          f"on {blk.shape[1]} lanes ({float(generic.float().mean()):.6f} "
          f"with err > 1e-6): nsel, idx equal, max |dcode| {nn_err:.3g}, "
          f"max |derr| {nn_derr:.3g}")
    del a, b, nres

    # path (g): inpainting of the 512^2 image with 25% of the pixels missing
    mask = dt((np.random.default_rng(0).uniform(size=img.shape) > 0.25)
              .astype(np.float32))
    corrupted = img_d * mask
    lt.reset_launch_counts()
    filled = inpaint(corrupted, mask, Dd, T=8)
    torch.cuda.synchronize()
    launches_inp = lt.launch_counts()
    print(f"path (g) inpaint launches: {launches_inp}")
    miss = mask == 0
    err_before = float((corrupted - img_d).abs()[miss].mean())
    err_after = float((filled - img_d).abs()[miss].mean())
    known = float((filled - img_d).abs()[~miss].max())
    check(tuple(filled.shape) == (IMG_SIZE, IMG_SIZE)
          and bool(torch.isfinite(filled).all()), "inpaint: shape, finite")
    check(err_after < 0.25 * err_before,
          f"inpaint: missing-pixel error {err_after} against {err_before}")
    check(known <= 1e-4, f"inpaint changed known pixels by {known}")
    print(f"inpaint {IMG_SIZE}^2, {float(miss.float().mean()):.4f} missing: "
          f"mean error on the missing pixels {err_before:.4f} -> "
          f"{err_after:.4f}; known pixels within {known:.3g}")

    # path (h): the LLC encoder on the same signals
    llc_enc = lt.SparseEncoder("llc", {"knn": 5})
    lt.reset_launch_counts()
    Gl = llc_enc.encode(Xs, Ds)
    torch.cuda.synchronize()
    launches_h = lt.launch_counts()
    print(f"path (h) SparseEncoder('llc') launches: {launches_h}")
    check(tuple(Gl.shape) == (K, N_SWEEP) and bool(torch.isfinite(Gl).all()),
          "llc codes: shape, finite")
    sum_err = float((Gl.sum(dim=0) - 1.0).abs().max())
    check(sum_err <= 1e-5, f"llc codes sum to 1 within {sum_err}")
    # the support is the 5 atoms of largest d.x, up to float32 rounding of
    # d.x (1e-5 on unit vectors)
    sup_gap = -1.0
    for s in range(0, N_SWEEP, 16384):
        Gb = Gl[:, s:s + 16384].T
        sim = Xs[:, s:s + 16384].T.double() @ Ds.double()
        sup = Gb != 0
        check(bool((sup.sum(dim=1) == 5).all()), "llc support size")
        lo = torch.where(sup, sim, math.inf).amin(dim=1)
        hi = torch.where(sup, -math.inf, sim).amax(dim=1)
        sup_gap = max(sup_gap, float((hi - lo).max()))
    check(sup_gap <= 1e-5, f"llc support is not the 5 largest d.x: {sup_gap}")
    # 1,024 lanes against a float64 numpy solve of the same system: a (5, 5)
    # system of unit-norm 64-dim atoms, solved by float32 CG in another
    # summation order, so the codes agree within 1e-4
    Gn = Gl[:, :1024].double().cpu().numpy()
    Dn = Ds.double().cpu().numpy()
    Xn64 = Xs[:, :1024].double().cpu().numpy()
    llc_err = 0.0
    for n in range(1024):
        sel = np.nonzero(Gn[:, n])[0]
        z = Dn[:, sel].T - Xn64[:, n][None, :]
        C = z @ z.T
        C += (1e-4 * np.trace(C) + 1e-12) * np.eye(len(sel))
        c = np.linalg.solve(C, np.ones(len(sel)))
        llc_err = max(llc_err, float(np.abs(Gn[sel, n] - c / c.sum()).max()))
    check(llc_err <= 1e-4, f"llc codes against float64: {llc_err}")
    print(f"llc N={N_SWEEP} knn=5: codes sum to 1 within {sum_err:.3g}; the "
          f"support is the 5 largest d.x (gap {sup_gap:.3g}); 1024 lanes "
          f"within {llc_err:.3g} of a float64 solve")
    del Gl

    ref = omp_fused_reference(Db, Xb, T=T)
    check(tuple(res.idx.shape) == (Xb.shape[1], T), "batch_omp idx shape")
    check(bool(torch.isfinite(res.gamma).all()), "batch_omp gamma finite")
    agree = float((res.idx == ref[0]).all(dim=1).float().mean())
    check(agree >= 0.999, f"batch_omp idx agreement {agree}")
    del ref

    out_plain = plain_denoise(torch, noisy, Dd, cfg, SIGMA)
    check(tuple(out.shape) == (IMG_SIZE, IMG_SIZE), "denoise shape")
    check(bool(torch.isfinite(out).all()), "denoise output finite")
    p_noisy = lt.psnr(noisy, img_d)
    p_out = lt.psnr(out, img_d)
    p_plain = lt.psnr(out_plain, img_d)
    print(f"denoise {IMG_SIZE}^2 sigma={SIGMA}: PSNR noisy {p_noisy:.4f} dB,"
          f" kernel path {p_out:.4f} dB, plain path {p_plain:.4f} dB")
    check(p_out > p_noisy + 3.0, "denoise gains less than 3 dB")
    check(abs(p_out - p_plain) <= 0.05, "kernel and plain denoise differ")

    # --- 7. a p=768 colour denoise: 16 x 16 x 3 patches of a small image,
    # through whichever route the denoiser's gate picks (the two-phase coder
    # on K2 where the kernel takes the shape, else blocked Batch-OMP),
    # against the same denoise on the CPU
    rgb = synthetic_color_image("texture", COLOR_SIZE, seed=0)
    noisy_rgb = (rgb + SIGMA * np.random.default_rng(1).standard_normal(
        rgb.shape)).astype(np.float32)
    D768 = dct_dictionary_color(16, 256, device="cpu")
    cfg768 = lt.DenoiseConfig(patch=16, sigma=SIGMA)
    den768 = Denoiser(D768.to(dev), cfg768)
    on_k2 = den768._fast_path()
    lt.reset_launch_counts()
    out768 = den768(dt(noisy_rgb))
    torch.cuda.synchronize()
    launches768 = lt.launch_counts()
    check(launches768["omp_fused_eps"] == int(on_k2)
          and launches768["gram"] == int(on_k2),
          f"p=768 denoise: route {'K2' if on_k2 else 'batch_omp'}, launches "
          f"{launches768}")
    out768_cpu = Denoiser(D768, cfg768)(torch.from_numpy(noisy_rgb))
    p768 = lt.psnr(out768.cpu(), rgb)
    p768_cpu = lt.psnr(out768_cpu, rgb)
    check(tuple(out768.shape) == rgb.shape
          and bool(torch.isfinite(out768).all())
          and abs(p768 - p768_cpu) <= 0.05,
          f"p=768 denoise: PSNR {p768} on the GPU, {p768_cpu} on the CPU")
    print(f"denoise {COLOR_SIZE}^2 colour, 16 x 16 patches (p=768, K=256): "
          f"route {'K2 (two-phase)' if on_k2 else 'blocked batch_omp'}, "
          f"launches {launches768}; PSNR noisy "
          f"{lt.psnr(noisy_rgb, rgb):.4f} dB, GPU {p768:.4f} dB, CPU "
          f"{p768_cpu:.4f} dB")

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
    den_plain_ms = cuda_ms(torch, lambda: plain_denoise(torch, noisy, Dd, cfg,
                                                        SIGMA))
    print(f"denoise {IMG_SIZE}^2: kernel path {den_ms / 1e3:.4f} s, plain "
          f"path {den_plain_ms / 1e3:.4f} s")
    for cd in ("f32", "bf16"):
        on = cuda_ms(torch, lambda: _omp_impl(
            Db, Xb, 0.0, T=T, eps_mode=False, corr_dtype=cd,
            fused_select=True))
        off = cuda_ms(torch, lambda: _omp_impl(
            Db, Xb, 0.0, T=T, eps_mode=False, corr_dtype=cd))
        print(f"_omp_impl corr_dtype={cd} p={P} K={K} T={T} N={N}: "
              f"fused_select=True {on:.3f} ms = {N / on * 1e3:.1f} "
              f"patches/s; False {off:.3f} ms = {N / off * 1e3:.1f} "
              f"patches/s")
    for what, enc, kw in (("nn_omp", nn_enc, {"dense": False}),
                          ("llc", llc_enc, {})):
        ms = cuda_ms(torch, lambda: enc.encode(Xs, Ds, **kw), reps=3)
        print(f"{what} encoder (blocks of {enc.block}) p={P} K={K} "
              f"N={N_SWEEP}: {ms:.3f} ms = {N_SWEEP / ms * 1e3:.1f} "
              f"patches/s")
    for unroll in (False, True):
        ms = cuda_ms(torch, lambda: lt.nn_omp(Ds, blk, T, dense=False,
                                              unroll=unroll), reps=3)
        print(f"nn_omp unroll={unroll} one block N={blk.shape[1]}: "
              f"{ms:.3f} ms = {blk.shape[1] / ms * 1e3:.1f} patches/s")
    inp_ms = cuda_ms(torch, lambda: inpaint(corrupted, mask, Dd, T=8),
                     reps=3)
    print(f"inpaint {IMG_SIZE}^2 K=256 T=8 ({NP} patches): "
          f"{inp_ms / 1e3:.4f} s")

    # --- 8. the dictionary-learning paths
    (launches_i, launches_j, launches_k), ksvd_out = ksvd_paths(
        torch, lt, dev, img, noisy, img_d)
    # --- 9. online dictionary learning and the classifiers
    (launches_l, launches_m, launches_n), learning_out = learning_paths(
        torch, lt, dev)
    # --- 10. LARS, config 6 and K3's whitening, the runner
    launches_o, lars_out = lars_paths(torch, lt, dev)
    launches_p, launches_q, feature_out = feature_paths(torch, lt, dev)
    launches_r, runner_out = runner_paths(torch, lt, dev)
    # --- 11. the device mesh
    launches_s, mesh_out = mesh_paths(torch, lt, dev, card, Db, Xb, Dd,
                                      img_d, noisy)
    # --- 12. K1/K2 above the Gram form's cap, SRC on 16,800 atoms
    launches_t, launches_n2, large_k_out, lk = large_k_paths(torch, lt, dev,
                                                             card)
    # ptxas on every instance of the residual form: its init and step
    # kernels and the listed float32 selection
    lk_ptxas = ptxas_report(log, r"omp_residual_cu|f3213select_kernelILi\d+ELb1E")
    for name, rep in sorted(lk_ptxas.items()):
        print(f"(t) ptxas {name}: {rep}")
    check(len(lk_ptxas) == 6 and all(len(r) == 3 for r in lk_ptxas.values()),
          f"(t) ptxas: six residual-form instances expected, got {lk_ptxas}")
    paths = (launches, launches_g, launches_b, launches_d, launches_e,
             launches_f, launches_inp, launches_h, launches_i, launches_j,
             launches_k, launches_l, launches_m, launches_n, launches_o,
             launches_p, launches_q, launches_r, launches_s, launches_t,
             launches_n2)
    for name in launches:
        total = sum(counts[name] for counts in paths)
        check(total > 0, f"kernel {name} not launched on any main path")

    # library_ms: one PyTorch call computing the same function, where one
    # exists (K7's is the reference profile's matmul + argmax pair)
    kernels = [
        {"name": "omp_fused (fixed T)", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/omp_fused.cu",
         "replaces": "lyssandra_tpu/ops/pallas_omp.py:79",
         "launches": launches["omp_fused_t"] + launches_b["omp_fused_t"]
         + launches_i["omp_fused_t"] + launches_j["omp_fused_t"]
         + launches_n["omp_fused_t"] + launches_p["omp_fused_t"]
         + launches_r["omp_fused_t"] + launches_s["omp_fused_t"],
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "lanes_per_block": k1_lanes, "parts_ms": k1_parts,
         "gram_rows_tb_per_s": k1_row_rate / 1e12,
         "alpha0_tflop_per_s": k1_alpha0_rate / 1e12},
        {"name": "omp_fused (eps exit)", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/omp_fused.cu",
         "replaces": "lyssandra_tpu/ops/pallas_omp.py:235",
         "launches": launches["omp_fused_eps"] + launches_k["omp_fused_eps"]
         + launches_r["omp_fused_eps"] + launches_s["omp_fused_eps"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "lanes_per_block": k2_lanes},
        {"name": "fused_patches", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/fused_patches.cu",
         "replaces": "lyssandra_tpu/ops/pallas_patches.py:37",
         "launches": launches["fused_patches"] + launches_k["fused_patches"]
         + launches_q["fused_patches"] + launches_r["fused_patches"]
         + launches_s["fused_patches"],
         "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None,
         "graph_ms": k3_graph_ms, "variants": k3_times},
        {"name": "group_omp_fused", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/group_omp.cu",
         "replaces": "lyssandra_tpu/ops/pallas_group.py:52,253",
         "launches": launches_g["group_omp_fused"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0],
         "bound_by": k4_bound[1], "library_ms": None},
        {"name": "fs_cold", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/fs_cold.cu",
         "replaces": "lyssandra_tpu/ops/pallas_fs.py:53",
         "launches": launches_d["fs_cold"] + launches_m["fs_cold"],
         "max_abs_err": k6_err,
         "ms": k6_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound[0],
         "bound_by": k6_bound[1], "library_ms": None},
        # times at a coding block of the online fit (N=1024), by_lanes
        # also at N=4096; max_abs_err is the widest relative objective gap
        # over the plain version's codes (config 4, N=1024 and 4096)
        {"name": "fs_scan", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/fs_scan.cu",
         "replaces": "none: lyssandra_tpu/solvers/lasso.py's "
                     "feature_sign_scan lax.while_loop",
         "launches": launches_l["fs_scan"] + launches_r["fs_scan"]
         + launches_s["fs_scan"],
         "max_abs_err": scan_err, "ms": scan_t[1024]["ms"],
         "plain_ms": scan_t[1024]["plain_ms"],
         "graph_ms": scan_t[1024]["graph_ms"],
         "bound_ms": scan_t[1024]["bound_ms"],
         "bound_by": scan_t[1024]["bound_by"], "library_ms": None,
         "by_lanes": scan_t},
        # one sweep at config 4 from path (l)'s learned state; max_abs_err
        # is the widest atom distance to the float64 sweep
        {"name": "online_sweep", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/online_sweep.cu",
         "replaces": "none: lyssandra_tpu/dict_learning/online.py's "
                     "_dict_update_body lax.scan",
         "launches": launches_l["online_sweep"]
         + launches_m["online_sweep"] + launches_r["online_sweep"]
         + launches_s["online_sweep"],
         "max_abs_err": learning_out["online_sweep"]["gap_max"],
         **{k: learning_out["online_sweep"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "us_per_atom", "by_cluster_ms", "cluster")},
         "library_ms": None},
        # one B=1 sweep at config 2 from path (i)'s learned D and its K1
        # codes; max_abs_err is the widest atom distance to the float64
        # sweep; library_ms the dense sweep replayed from its CUDA graph
        {"name": "ksvd_sweep", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/ksvd_sweep.cu",
         "replaces": "none: lyssandra_tpu/dict_learning/ksvd.py's "
                     "atom sweep lax loop",
         "launches": sum(counts["ksvd_sweep"] for counts in paths),
         "max_abs_err": ksvd_out["ksvd_sweep"]["gap_max"],
         **{k: ksvd_out["ksvd_sweep"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "us_per_atom", "library_ms")}},
        {"name": "select_abs_argmax", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/select.cu",
         "replaces": "lyssandra_tpu/ops/pallas_select.py:35",
         "launches": launches_e["select_abs_argmax"],
         "max_abs_err": k7_err, "mismatch_share": k7_share,
         "ms": k7_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bound[0],
         "bound_by": k7_bound[1], "library_ms": k7_lib_ms,
         "graph_ms": k7_graph_ms, "library_graph_ms": k7_lib_graph_ms,
         "bf16_ms": k7_bf16_ms, "bf16_graph_ms": k7_bf16_graph_ms,
         "bf16_plain_ms": k7_plain_bf16_ms,
         "bf16_library_ms": k7_bf16_lib_ms,
         "bf16_library_graph_ms": k7_bf16_lib_graph_ms,
         "bf16_max_abs_err": k7_err_bf16, "bf16_bound_ms": k7_bound_bf16[0],
         "bf16_bound_by": k7_bound_bf16[1]},
        # the residual form above the Gram form's cap: times at p=64,
        # K=16,384, T=8, N=32,768 (path (t)); launches (init, one a call on
        # these paths; the selection's and the update's, both modes
        # together) on the grid of (t), the replicated omp of (s2) and
        # SRC's predict (n2); library_ms the selection alone as
        # argmax(abs(r @ D)) a step
        *({"name": f"omp_residual ({what})", "route": "cuda",
           "source": "lyssandra_tpu_torch/csrc/omp_residual.cu, "
                     "lyssandra_tpu_torch/csrc/select.cu",
           "replaces": f"lyssandra_tpu/ops/pallas_omp.py:{line}",
           "launches": launches_t[key] + launches_s[key] + launches_n2[key],
           "step_launches": {
               part: launches_t[c] + launches_s[c] + launches_n2[c]
               for part, c in (("selection", "omp_residual_select"),
                               ("update", "omp_residual_update"))},
           "ptxas": {k: v for k, v in lk_ptxas.items()
                     if tag in k or "select" in k},
           **lk[row]}
          for what, line, key, row, tag in (
              ("fixed T", 79, "omp_residual_t", "K1-L", "ILb0E"),
              ("eps exit", 235, "omp_residual_eps", "K2-L", "ILb1E"))),
        # times at K4's alpha0 shape (a group-encoder block); by_shape has
        # every main-path shape
        {"name": "gram", "route": "cuda",
         "source": "lyssandra_tpu_torch/csrc/gram.cu",
         "replaces": "lyssandra_tpu/ops/pallas_fs.py:53, "
                     "lyssandra_tpu/ops/pallas_group.py:52,253 and "
                     "lyssandra_tpu/ops/pallas_omp.py:79,235 (their D^T x)",
         "launches": sum(counts["gram"] for counts in paths),
         "max_abs_err": gram_err, "max_rel_err": gram_rel,
         "ms": gram_times[0]["ms"], "plain_ms": gram_times[0]["plain_ms"],
         "graph_ms": gram_times[0]["graph_ms"],
         "bound_ms": gram_times[0]["bound_ms"],
         "bound_by": gram_times[0]["bound_by"],
         "library_ms": gram_times[0]["library_ms"], "by_shape": gram_times},
    ]
    for k in kernels:
        check(all(math.isfinite(k[f]) for f in ("max_abs_err", "ms",
                                                 "plain_ms", "bound_ms")),
              f"non-finite measurement for {k['name']}")
        check(k["launches"] > 0, f"{k['name']} launched no time on its path")
    print(json.dumps(ksvd_out))
    print(json.dumps(learning_out))
    print(json.dumps({"lars": lars_out, **feature_out, "runner": runner_out},
                     default=str))
    print(json.dumps({"mesh": mesh_out}))
    print(json.dumps({"large_k": large_k_out}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
