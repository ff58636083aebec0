"""Entry ``ksvd_fit``: ``KSVDLearner(KSVDConfig(K, T, n_iter, ...)).fit(X)``,
the whole fit from the 'data' start, one task a request, on a pool of
training sets cycled in an order drawn from the run's seed.  Training set
s is the program's ``patch_dataset(images, p, n_train, seed=s)``, made
once on the card for every seed, so a task's work does not move with it.

The check follows one task, drawn from the seed among the first
``sample_span``, iteration by iteration: the harness wraps the program's
K-SVD iteration (``dict_learning.ksvd.ksvd_step``, and
``ksvd_step_compact`` should the learner take it), as the adaptive cell's
entry does, and, for that task alone, the ``encode`` of the learner's own
encoder (``KSVDLearner.encoder``, public), and keeps each iteration's
signals, dictionary in, codes, dictionary out and stats.  The reference

- draws the training set and the 'data' start itself (equal bit for bit);
- codes every lane by fixed-T OMP in float64 from the program's
  dictionary in, and holds the program's codes to it by each lane's
  residual energy (the data start's near-duplicate atoms tie within
  rounding, so the picks may part where the energies agree);
- sweeps from the program's own codes and replaces bad atoms, and holds
  the program's dictionary out to that atom by atom, and its stats to
  the reference's.

The names ``ksvd_step`` and ``ksvd_step_compact`` (each called once an
iteration with (X, D, encoder, ...), returning the new D first and the
stats last) stay part of the benchmark's contract with the program."""

import importlib

import numpy as np
import torch

from portbench.core import compare
from portbench.core.program import launches, sync
from portbench.core.trace import span
from portbench.reference.omp import dense
from portbench.yardstick import generate, work

STEPS = ("ksvd_step", "ksvd_step_compact")
NAMES = ("iterations_missing", "train_patch_gap", "dict0_gap", "chain_gap",
         "code_gap_p999", "code_gap_median", "atom_gap_max",
         "atom_gap_median", "stats_gap")


class Entry:
    unit = "tasks"

    def __init__(self, cell, seed, devices):
        self.cfg, self.tr = cell.config, cell.traffic
        self.seed = seed
        self.devices = devices
        self.counters = {}
        self.work = {}
        self.n = 0
        self.recording = None
        self.recorded = None
        self.codes = None
        self.follow_index = int(generate.sample_indices(
            seed, 7, self.tr["sample_span"], 1)[0])
        # the window runs until the followed task is done
        self.min_requests = self.follow_index + 1
        self.order = np.arange(self.tr["pool"])
        generate.shuffle(self.order, seed)

    def inputs(self):
        from lyssandra_tpu_torch.utils import patch_dataset

        cfg, dev = self.cfg, self.devices[0]
        imgs = generate.clean_images(cfg["images"], cfg["image"])
        self.pool = [torch.from_numpy(patch_dataset(
            imgs, p=cfg["patch"], n_patches=cfg["n_train"], seed=s).astype(
                np.float32)).to(dev) for s in range(self.tr["pool"])]

    def _wrap(self, name, step):
        def wrapped(X, D, *args, **kw):
            self.codes = None
            with span(name):
                out = step(X, D, *args, **kw)
            if self.recording is not None:
                self.recording.append((X, D, out[0], self.codes, out[-1]))
            return out
        return wrapped

    def _keep_codes(self, encode):
        def wrapped(*args, **kw):
            self.codes = encode(*args, **kw)
            return self.codes
        return wrapped

    def setup(self):
        import lyssandra_tpu_torch as lt

        cfg = self.cfg
        self.ksvd = importlib.import_module(
            "lyssandra_tpu_torch.dict_learning.ksvd")
        self.orig = {n: getattr(self.ksvd, n) for n in STEPS}
        for n, f in self.orig.items():
            setattr(self.ksvd, n, self._wrap(n, f))
        self.learner_cfg = lt.KSVDConfig(
            K=cfg["K"], T=cfg["T"], n_iter=cfg["n_iter"], init=cfg["init"],
            exact_svd=cfg["exact_svd"], replace_dead=cfg["replace_dead"],
            min_use=cfg["min_use"], max_coherence=cfg["max_coherence"],
            atom_block=cfg["atom_block"], codes=cfg["codes"],
            seed=cfg["seed"])
        self.learner_cls = lt.KSVDLearner
        self.inputs()
        for i in range(self.tr["warmup_requests"]):
            self._task(self.pool[i % len(self.pool)])
        sync(self.devices)
        self.launches0 = launches()

    def _task(self, X, follow=False):
        L = self.learner_cls(self.learner_cfg, device=self.devices[0])
        self.block = getattr(L.encoder, "block", X.shape[1])
        if follow:
            L.encoder.encode = self._keep_codes(L.encoder.encode)
        return L.fit(X)

    def request(self, i):
        k = int(self.order[i % len(self.order)])
        follow = i == self.follow_index
        self.recording = [] if follow else None
        with span("ksvd_fit"):
            L = self._task(self.pool[k], follow)
            sync(self.devices)
        if follow:
            self.recorded = (k, self.recording, L.D_)
            self.recording = None
        self.n += 1
        return 1

    def window_closed(self):
        self.counters["launches_per_request"] = (launches()
                                                 - self.launches0) / self.n

    def after_window(self, trace):
        pass

    def free(self):
        for n, f in self.orig.items():
            setattr(self.ksvd, n, f)
        self.learner_cls = None
        self.pool = None

    def check(self, ref):
        if self.recorded is None:           # the followed task failed
            return self.follow(ref, 0, [], None)
        return self.follow(ref, *self.recorded)

    def follow(self, ref, k, steps, D_final):
        """The numbers of one task on training set k: its iterations
        ``steps`` ((X, D in, D out, codes, stats) each) and the learner's
        D at the end, each iteration held against the reference's from
        the same D in and codes."""
        cfg, dev = self.cfg, self.devices[0]
        if not steps:
            return dict.fromkeys(NAMES, float("inf")) | {
                "iterations_missing": float(cfg["n_iter"])}
        X = ref.train_patches(cfg, k, dev)
        Xd = X.double()
        xn = (Xd * Xd).sum(dim=0)
        # a lane's energy, floored at 1e-10 of the mean: the flat patches'
        # columns are the DC removal's rounding (about 1e-24), where any
        # code is as good as any other
        xn = xn.clamp_min(1e-10 * float(xn.mean()))
        chain = [compare.max_abs(b[1], a[2]) for a, b in zip(steps,
                                                              steps[1:])]
        chain.append(compare.max_abs(D_final, steps[-1][2]))
        codes, atoms, stats, nsels = [], [], [], []
        for _, Din, Dout, got, st in steps:
            if got is None:                 # coded past the encoder
                codes.append(torch.full_like(xn, float("inf")))
                continue
            G = _dense(got, cfg["K"]).to(dev, torch.float64)
            Din = Din.double()
            R = Xd - Din @ G
            _, err, nsel = ref.code(X, Din, cfg)
            codes.append((((R * R).sum(dim=0) - err).abs() / xn))
            D_ref, st_ref = ref.from_codes(X, Din, G, cfg)
            atoms.append(compare.atoms(Dout, D_ref))
            gap = (st.to(dev, torch.float64) - st_ref).abs() \
                / st_ref.abs().clamp_min(1e-30)
            stats.append(float(gap.max()))
            nsels.append(nsel)
        codes = torch.cat(codes)
        atoms = torch.cat(atoms) if atoms else torch.full(
            (1,), float("inf"), dtype=torch.float64)
        self._count_work(X.shape[0], X.shape[1], nsels)
        return {
            "iterations_missing": float(abs(len(steps) - cfg["n_iter"])),
            # the start: the same arithmetic as the program's, so equal
            # bit for bit
            "train_patch_gap": max(compare.max_abs(s[0], X) for s in steps),
            "dict0_gap": compare.max_abs(steps[0][1], ref.dictionary(X, cfg)),
            # each iteration from the last, and the learner's D from the
            # last iteration's, bit for bit
            "chain_gap": max(chain),
            "code_gap_p999": float(torch.quantile(codes.cpu(), 0.999)),
            "code_gap_median": float(codes.median()),
            "atom_gap_max": float(atoms.max()),
            "atom_gap_median": float(atoms.median()),
            "stats_gap": max(stats) if stats else float("inf"),
        }

    def control(self, ref):
        """The check's numbers with the reference in the precision below
        the configuration's doing the followed task in the program's
        place: its own training set and data start, then each iteration's
        coding, sweep and replacement from its own dictionary."""
        cfg, dev = self.cfg, self.devices[0]
        k = int(self.order[self.follow_index % len(self.order)])
        X = ref.train_patches(cfg, k, dev)
        D = ref.dictionary(X, cfg)
        steps = []
        for _ in range(cfg["n_iter"]):
            G, _, _ = ref.code(X, D, cfg, control=True)
            Dn, st = ref.from_codes(X, D, G, cfg, control=True)
            steps.append((X, D, Dn, G, st))
            D = Dn
        return self.follow(ref, k, steps, D)

    def _count_work(self, p, N, nsels):
        """A task's work at the reference's nsel: the whole fit
        (``work.ksvd_iteration`` an iteration; X read and D written once)
        and its K1 launches, one a block of the encoder's lanes."""
        cfg = self.cfg
        K, T = cfg["K"], cfg["T"]
        nsels = [n.cpu().numpy() for n in nsels]
        flops = sum(work.ksvd_iteration(p, K, n, K) for n in nsels)
        self.work["call"] = (flops, work.F32 * (p * N + p * K))
        block = getattr(self, "block", N)
        f = b = 0
        for n in nsels:
            for j in range(0, N, block):
                fj, bj = work.omp_kernel(p, K, T, n[j:j + block])
                f, b = f + fj, b + bj
        self.work["k1"] = (f, b)
        self.work["k1_tag"] = "omp_fused_kernel"


def _dense(codes, K):
    """The program's codes as a dense (K, N) matrix: a dense Gamma as it
    is, compact (idx, gamma, ...) codes scattered."""
    if isinstance(codes, torch.Tensor):
        return codes
    return dense(codes[0].long(), codes[1], K)
