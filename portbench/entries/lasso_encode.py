"""Entry ``lasso_encode``: config 4's lasso coding,
``SparseEncoder("lasso", {"lam": ...}, block=...).encode(X, D)`` into
dense codes (K, N), one encode of one patch set a request, over the
dictionary config 4 learns.

Set-up makes the configuration's training set and pool of patch sets once
(the same for every seed), then learns D with the reference's plain online
learner (``configs/lasso-c4.py``'s ``learn``, float64, one epoch over the
training set, as config 4 does) and casts it to float32: the dictionary
is an input of the cell, like a model's weights, made without the
program, and both the program and the reference code from it.  The pool
is cycled in an order drawn from the run's seed.

The check wraps nothing: it keeps the codes of one request, drawn from
the seed among the first ``sample_span``, and holds

- their shape and finiteness (``lanes_missing``: the lanes not coded, or
  with a value that is not finite);
- every lane by the lasso's KKT conditions, in float64 in blocks;
- the lanes of one full block drawn from the seed, of the last (padded)
  block and the 256 lanes of widest KKT breach by their objective against
  the reference's float64 feature-sign optimum from the same D."""

import numpy as np
import torch

from portbench.core.program import sync
from portbench.core.trace import span
from portbench.yardstick import color, generate, lasso_encode_work

NAMES = ("lanes_missing", "kkt_max", "kkt_median", "obj_gap_max",
         "obj_gap_median")
KKT_BLOCK = 8192         # lanes a float64 KKT product of the check
CONTROL_BLOCK = 16384    # lanes a call of the control's lasso
WIDEST = 256             # lanes of widest KKT breach held by objective


def _unit(X):
    """float32 columns scaled to unit norm, as config 4 scales them."""
    X = X.astype(np.float32)
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-8)
    return X


class Entry:
    unit = "tasks"

    def __init__(self, cell, seed, devices):
        self.cfg, self.tr = cell.config, cell.traffic
        self.ref = cell.reference()
        self.seed = seed
        self.devices = devices
        self.counters = {}
        self.work = {}
        self.n = 0
        self.kept = None
        self.follow_index = int(generate.sample_indices(
            seed, 9, self.tr["sample_span"], 1)[0])
        # the window runs until the followed request is done
        self.min_requests = self.follow_index + 1
        self.order = np.arange(len(self.cfg["pool_seeds"]))
        generate.shuffle(self.order, seed)

    def inputs(self):
        """The training set and the pool of patch sets, on the card."""
        cfg, dev = self.cfg, self.devices[0]
        self.train = torch.from_numpy(
            color.unit_patches(cfg)[:, :cfg["n_train"]]).to(dev)
        imgs = [color.synthetic_color_image(k, cfg["image"], seed=s)
                for s, k in enumerate(cfg["images"])]
        self.pool = [torch.from_numpy(_unit(color.patches(
            imgs, cfg["patch"], cfg["n_encode"], s))).to(dev)
            for s in cfg["pool_seeds"]]

    def learn(self):
        """D: the reference's online learner over the training set, one
        epoch, cast to float32."""
        self.D = self.ref.learn(self.train, self.cfg).to(
            torch.float32).contiguous()
        self.train = None

    def setup(self):
        import lyssandra_tpu_torch as lt
        from lyssandra_tpu_torch.solvers.lasso import host_syncs

        cfg = self.cfg
        self.host_syncs = host_syncs
        self.inputs()
        self.learn()
        self.enc = lt.SparseEncoder("lasso", {
            "lam": cfg["lam"], "max_active": cfg["max_active"],
            "max_iter": cfg["max_iter"], "max_inner": cfg["max_inner"]},
            block=cfg["block"])
        for i in range(self.tr["warmup_requests"]):
            self.enc.encode(self.pool[self.order[i % len(self.order)]],
                            self.D)
        sync(self.devices)
        self.syncs0 = host_syncs()

    def request(self, i):
        k = int(self.order[i % len(self.order)])
        with span("lasso_encode"):
            Gamma = self.enc.encode(self.pool[k], self.D)
            sync(self.devices)
        self.n += 1
        if i == self.follow_index:
            self.kept = (k, Gamma)
        return 1

    def window_closed(self):
        self.counters["fs_syncs"] = (self.host_syncs()
                                     - self.syncs0) / self.n

    def after_window(self, trace):
        pass

    def free(self):
        self.enc = None

    def check(self, ref):
        if self.kept is None:               # the followed request failed
            return self.follow(ref, self.pool[0], None)
        k, Gamma = self.kept
        self.kept = None
        return self.follow(ref, self.pool[k], Gamma)

    def lanes(self, N, kkt):
        """(the lanes of the drawn full block and of the last block, the
        lanes held by objective): those and the WIDEST of widest KKT
        breach, each once."""
        B = self.cfg["block"]
        full = N // B
        b = int(generate.sample_indices(self.seed, 10, max(full, 1), 1)[0])
        drawn = np.arange(b * B, min((b + 1) * B, N))
        last = np.arange(((N - 1) // B) * B, N)
        blocks = np.union1d(drawn, last)
        widest = torch.topk(kkt, min(WIDEST, N)).indices.cpu().numpy()
        return blocks, np.union1d(blocks, widest)

    def follow(self, ref, X, Gamma):
        """The check's numbers of codes Gamma (K, N) of the signals X."""
        cfg, D = self.cfg, self.D
        N = X.shape[1]
        if Gamma is None or tuple(Gamma.shape) != (cfg["K"], N):
            return dict.fromkeys(NAMES, float("inf")) | {
                "lanes_missing": float(N)}
        finite = torch.isfinite(Gamma).all(dim=0)
        kkt = torch.cat([ref.kkt(D, X[:, j:j + KKT_BLOCK],
                                 Gamma[:, j:j + KKT_BLOCK], cfg)
                         for j in range(0, N, KKT_BLOCK)])
        kkt = torch.where(finite, kkt, torch.inf)
        blocks, held = self.lanes(N, kkt)
        lt = torch.from_numpy(held).to(X.device)
        Xs = X[:, lt]
        G_ref, _ = ref.lasso(D, Xs, cfg)
        f_ref = ref.objective(D, Xs, G_ref, cfg)
        f = ref.objective(D, Xs, Gamma[:, lt], cfg)
        obj = (f - f_ref) / f_ref.clamp_min(1e-30)
        in_blocks = torch.from_numpy(np.isin(held, blocks)).to(X.device)
        G_blocks = G_ref[:, in_blocks]
        nnz = (G_blocks != 0).sum(dim=0).cpu().numpy()
        n_atoms = int((G_blocks != 0).any(dim=1).sum())
        p, K = X.shape[0], cfg["K"]
        self.work["call"] = lasso_encode_work.call(p, K, np.resize(nnz, N))
        self.work["k6"] = lasso_encode_work.cold_starts(
            K, cfg["cold_unroll"], cfg["block"], nnz, N, n_atoms)
        self.work["k6_tag"] = "fs_cold_kernel"
        return {
            "lanes_missing": float(N - int(finite.sum())),
            "kkt_max": float(kkt.max()),
            "kkt_median": float(kkt.median()),
            "obj_gap_max": float(obj.max()),
            "obj_gap_median": float(obj.median()),
        }

    def control(self, ref):
        """The check's numbers with the reference in the precision below
        the configuration's coding the followed patch set in the
        program's place, from the cell's D."""
        self.inputs()
        self.learn()
        k = int(self.order[self.follow_index % len(self.order)])
        X = self.pool[k]
        Gamma = torch.cat([ref.lasso(self.D, X[:, j:j + CONTROL_BLOCK],
                                     self.cfg, control=True)[0]
                           for j in range(0, X.shape[1], CONTROL_BLOCK)],
                          dim=1)
        return self.follow(ref, X, Gamma)
