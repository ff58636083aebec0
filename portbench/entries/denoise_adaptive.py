"""Entry ``denoise_adaptive``: ``denoise_adaptive(noisy, sigma, K=...,
n_iter=..., n_train=..., return_dictionary=True)`` on a pool of noisy
images made as entry ``denoise`` makes its own, one task (K-SVD learned on
the noisy image's own patches, then the image restored with that
dictionary) a request, cycled in an order drawn from the run's seed.  The
pool's noise is drawn once from the mix's ``noise_seed``, the same for
every seed, and the pool is small enough that every run serves each of
its images about equally often, so the work does not move with the seed.

The check follows one task, drawn from the seed among the first
``sample_span``, step by step: the harness wraps the program's K-SVD
iteration (``dict_learning.ksvd.ksvd_step``, and ``ksvd_step_compact``
should the learner take it) and, for that task alone, keeps a reference to
each iteration's training signals, dictionary in and dictionary out.  The
reference draws the training patches itself, starts from its own DCT
dictionary, runs each iteration from the program's dictionary in, and
restores the image with the dictionary it learned in the last one.  The
names ``ksvd_step`` and ``ksvd_step_compact`` of
``lyssandra_tpu_torch.dict_learning.ksvd``, each called once an iteration
with (X, D, ...) and returning the new D first, are therefore part of the
benchmark's contract with the program (the program has no public hook
that hands out each iteration's dictionary);
``tests/test_portbench_faults.py`` fails when a fit stops calling them."""

import importlib

import numpy as np
import torch

from portbench.core import compare
from portbench.core.program import launches, sync
from portbench.core.trace import span
from portbench.yardstick import generate, work

STEPS = ("ksvd_step", "ksvd_step_compact")


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
        self.follow_index = int(generate.sample_indices(
            seed, 4, self.tr["sample_span"], 1)[0])
        # the window runs until the followed task is done
        self.min_requests = self.follow_index + 1

    def inputs(self):
        cfg, tr, dev = self.cfg, self.tr, self.devices[0]
        gen = generate.generator(tr["noise_seed"], dev)
        clean = generate.clean_images(cfg["images"], cfg["image"])
        self.pool = generate.noisy_pool(clean, cfg["sigma"], tr["pool"],
                                        gen, dev)
        self.order = np.arange(tr["pool"])
        generate.shuffle(self.order, self.seed)

    def _wrap(self, name, step):
        def wrapped(X, D, *args, **kw):
            with span(name):
                out = step(X, D, *args, **kw)
            if self.recording is not None:
                self.recording.append((X, D, out[0]))
            return out
        return wrapped

    def setup(self):
        import lyssandra_tpu_torch as lt
        from lyssandra_tpu_torch.apps import denoise_adaptive

        cfg, tr = self.cfg, self.tr
        self.ksvd = importlib.import_module(
            "lyssandra_tpu_torch.dict_learning.ksvd")
        self.orig = {n: getattr(self.ksvd, n) for n in STEPS}
        for n, f in self.orig.items():
            setattr(self.ksvd, n, self._wrap(n, f))
        self.task = denoise_adaptive
        self.inputs()
        self.den_cfg = lt.DenoiseConfig(patch=cfg["patch"], sigma=cfg["sigma"],
                                        gain=cfg["gain"], lam=cfg["lam"],
                                        T_max=cfg["T_max"])
        for i in range(tr["warmup_requests"]):
            self._task(self.pool[i % len(self.pool)])
        sync(self.devices)
        self.launches0 = launches()

    def _task(self, noisy):
        cfg = self.cfg
        return self.task(
            noisy, cfg["sigma"], cfg=self.den_cfg, K=cfg["K"],
            n_iter=cfg["n_iter"], n_train=cfg["n_train"],
            return_dictionary=True, device=self.devices[0])

    def request(self, i):
        k = int(self.order[i % len(self.order)])
        self.recording = [] if i == self.follow_index else None
        with span("denoise_adaptive"):
            out, D = self._task(self.pool[k])
            sync(self.devices)
        if self.recording is not None:
            self.recorded = (k, self.recording, out)
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
        self.task = None

    def check(self, ref):
        if self.recorded is None:           # the followed task failed
            return self.follow(ref, 0, [], None)
        return self.follow(ref, *self.recorded)

    def follow(self, ref, k, steps, out):
        """The numbers of one task on pool entry k: its iterations
        ``steps`` ((X, D in, D out) each) and its restored image ``out``,
        each iteration held against the reference's from the same D in."""
        cfg = self.cfg
        n_iter = float(cfg["n_iter"])
        if not steps:
            return dict.fromkeys(
                ("train_patch_gap", "dict0_gap", "atom_gap_max",
                 "atom_gap_median", "image_rms_gap"), float("inf")) | {
                "iterations_missing": n_iter}
        noisy = self.pool[k]
        dev = self.devices[0]
        X = ref.train_patches(noisy, cfg, dev)
        D0 = ref.dictionary(cfg, dev)
        gaps, nsels = [], []
        for _, Din, Dout in steps:
            Dref, nsel = ref.ksvd_iteration(X, Din, cfg)
            gaps.append(compare.atoms(Dout, Dref))
            nsels.append(nsel)
        gaps = torch.cat(gaps)
        img, nsel_den = ref.denoise(Dref, noisy, cfg)
        self._count_work(nsels, nsel_den)
        return {
            "iterations_missing": abs(len(steps) - n_iter),
            # the start: the same float64 arithmetic rounded to float32,
            # so equal bit for bit
            "train_patch_gap": compare.max_abs(steps[0][0], X),
            "dict0_gap": compare.max_abs(steps[0][1], D0),
            "atom_gap_max": float(gaps.max()),
            "atom_gap_median": float(gaps.median()),
            "image_rms_gap": compare.images(out, img),
        }

    def control(self, ref):
        """The check's numbers with the reference in the precision below
        the configuration's doing the followed task in the program's
        place: its own training patches, DCT start, iterations and
        denoise."""
        cfg, dev = self.cfg, self.devices[0]
        self.inputs()
        k = int(self.order[self.follow_index % len(self.order)])
        noisy = self.pool[k]
        X = ref.train_patches(noisy, cfg, dev, control=True)
        D = ref.dictionary(cfg, dev, control=True)
        steps = []
        for _ in range(cfg["n_iter"]):
            Dn, _ = ref.ksvd_iteration(X, D, cfg, control=True)
            steps.append((X, D, Dn))
            D = Dn
        out, _ = ref.denoise(D, noisy, cfg, control=True)
        return self.follow(ref, k, steps, out)

    def _count_work(self, nsels, nsel_den):
        cfg = self.cfg
        p2, K, H = cfg["patch"] ** 2, cfg["K"], cfg["image"]
        flops = sum(work.ksvd_iteration(p2, K, n.cpu().numpy(), K)
                    for n in nsels)
        f, b = work.denoise_call(p2, K, H, H, nsel_den.cpu().numpy(), K)
        self.work["call"] = (flops + f, b)
