"""Entry ``denoise``: ``Denoiser(dct_dictionary(patch, K),
DenoiseConfig(...))(noisy)`` on a pool of noisy images (the
configuration's clean images plus noise drawn once from the mix's
``noise_seed``), one image a request, cycled in an order drawn from the
run's seed.  The pool is the same for every seed because the work of an
image depends on its noise: about one image in thirty has patches that
need more than the first phase's 10 atoms, and its second phase costs
10-20 ms.  So the pool is large enough to hold such images at that rate,
and a run serves each of them as often as the others.

Each image is timed on the device as well as on the host: CUDA events
recorded on the stream at hand-in and after the restored image, read once
it is synchronised (a 2 ms wait is too short for the host's clock).

Kept for the check: the last restored image of ``sample_images`` pool
entries drawn from the seed, and that of the request that waited longest
on the device; each is held against the configuration's reference, which
restores the same noisy images itself."""

import sys
import warnings

import numpy as np
import torch

from portbench.core import compare
from portbench.core.program import launches, sync
from portbench.core.trace import span
from portbench.yardstick import generate, work


def count_syncs(fn, device):
    """The synchronizing CUDA calls fn() makes, by torch's sync debug
    mode (None off a GPU).  Copied from ``chip_smoke.count_syncs``."""
    if device.type != "cuda":
        return None
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


class Entry:
    unit = "images"

    def __init__(self, cell, seed, devices):
        self.cfg, self.tr = cell.config, cell.traffic
        self.seed = seed
        self.devices = devices
        self.counters = {}
        self.work = {}
        self.outs = {}
        self.longest = (-1.0, None, None)   # (ms, pool entry, image)
        self.device_ms = []
        self.n = 0
        # the window serves every image of the pool at least once
        self.min_requests = self.tr["pool"]

    def inputs(self):
        cfg, tr, dev = self.cfg, self.tr, self.devices[0]
        gen = generate.generator(tr["noise_seed"], dev)
        clean = generate.clean_images(cfg["images"], cfg["image"])
        self.pool = generate.noisy_pool(clean, cfg["sigma"], tr["pool"],
                                        gen, dev)
        self.order = np.arange(tr["pool"])
        generate.shuffle(self.order, self.seed)
        self.keep = self.picked()

    def picked(self):
        """The pool entries whose last restored image the check compares."""
        return [int(k) for k in generate.sample_indices(
            self.seed, 3, len(self.pool), self.tr["sample_images"])]

    def setup(self):
        import lyssandra_tpu_torch as lt

        cfg, tr, dev = self.cfg, self.tr, self.devices[0]
        self.inputs()
        D = lt.dct_dictionary(cfg["patch"], cfg["K"], device=dev)
        self.den = lt.Denoiser(D, lt.DenoiseConfig(
            patch=cfg["patch"], sigma=cfg["sigma"], gain=cfg["gain"],
            lam=cfg["lam"], T_max=cfg["T_max"]), device=dev)
        for i in range(tr["warmup_requests"]):
            self.den(self.pool[i % len(self.pool)])
        sync(self.devices)
        self.launches0 = launches()

    def request(self, i):
        k = int(self.order[i % len(self.order)])
        on_card = self.devices[0].type == "cuda"
        with span("denoise"):
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                ev[0].record()
            out = self.den(self.pool[k])
            if on_card:
                ev[1].record()
            sync(self.devices)
        if on_card:
            ms = ev[0].elapsed_time(ev[1])
            self.device_ms.append(ms)
        else:
            ms = 0.0
        if k in self.keep:
            self.outs[k] = out
        if ms > self.longest[0]:
            self.longest = (ms, k, out)
        self.n += 1
        return 1

    def window_closed(self):
        self.counters["launches_per_request"] = (launches()
                                                 - self.launches0) / self.n
        self.counters["device_ms"], self.device_ms = self.device_ms, []

    def after_window(self, trace):
        if trace:
            per_image = [count_syncs(lambda: self.den(x), self.devices[0])
                         for x in self.pool]
            if per_image[0] is not None:
                self.counters["syncs_per_request"] = (sum(per_image)
                                                      / len(per_image))
                print(f"portbench: {sum(n > 1 for n in per_image)} of "
                      f"{len(per_image)} pool images synchronise more than "
                      f"once (a second phase)", file=sys.stderr)

    def free(self):
        self.sampled = [(k, self.outs[k]) for k in self.keep]
        _, k, out = self.longest
        if k is not None and k not in self.keep:
            self.sampled.append((k, out))
        self.outs, self.longest, self.den = {}, (-1.0, None, None), None

    def check(self, ref):
        cfg = self.cfg
        gaps, nsels = [], []
        D = ref.dictionary(cfg, self.devices[0])
        for k, out in self.sampled:
            img, nsel = ref.denoise(D, self.pool[k], cfg)
            gaps.append(compare.images(out, img))
            if k in self.keep:           # the work of an image drawn alike
                nsels.append(nsel)
        self._count_work(nsels)
        return {"image_rms_gap": max(gaps)}

    def control(self, ref):
        """The check's numbers with the reference in the precision below
        the configuration's restoring the picked images in the program's
        place."""
        self.inputs()
        cfg, dev = self.cfg, self.devices[0]
        D, Dc = ref.dictionary(cfg, dev), ref.dictionary(cfg, dev, True)
        gaps = [compare.images(ref.denoise(Dc, self.pool[k], cfg, True)[0],
                               ref.denoise(D, self.pool[k], cfg)[0])
                for k in self.picked()]
        return {"image_rms_gap": max(gaps)}

    def _count_work(self, nsels):
        cfg = self.cfg
        p2, K, H = cfg["patch"] ** 2, cfg["K"], cfg["image"]
        T1 = min(10, cfg["T_max"])
        calls, k2 = [], []
        for nsel in nsels:
            n = nsel.cpu().numpy()
            calls.append(work.denoise_call(p2, K, H, H, n, K))
            k2.append(work.omp_kernel(p2, K, T1, np.minimum(n, T1)))
        self.work["call"] = tuple(np.mean(calls, axis=0))
        self.work["k2"] = tuple(np.mean(k2, axis=0))
        self.work["k2_tag"] = "omp_fused_kernel"
