"""Entry ``encode``: ``SparseEncoder(algorithm, {"T": T},
block=...).encode(X, D, dense=False)`` on a pool of Gaussian signal sets,
one set a request, cycled.

Kept for the check: the codes of the requests drawn from the seed among
the first ``sample_span`` and of the last request, of which
``sample_lanes`` lanes each, drawn from the seed, are held against the
configuration's reference."""

import torch

from portbench.core import compare
from portbench.core.program import launches, sync
from portbench.core.trace import span
from portbench.yardstick import generate, work


class Entry:
    unit = "patches"

    def __init__(self, cell, seed, devices):
        self.cfg, self.tr = cell.config, cell.traffic
        self.seed = seed
        self.devices = devices
        self.counters = {}
        self.work = {}
        self.kept = {}
        self.last = None
        self.n = 0
        self.keep = set(generate.sample_indices(
            seed, 1, self.tr["sample_span"],
            self.tr["sample_requests"]).tolist())

    def inputs(self):
        cfg, tr, dev = self.cfg, self.tr, self.devices[0]
        gen = generate.generator(self.seed, dev)
        self.D = generate.unit_gaussian_dictionary(cfg["p"], cfg["K"], gen,
                                                   dev)
        self.pool = [generate.gaussian_signals(
            cfg["p"], tr["patches_per_request"], gen, dev)
            for _ in range(tr["pool"])]

    def lanes(self, j, device):
        """The lanes of the j-th kept answer that the check compares."""
        return torch.as_tensor(generate.sample_indices(
            self.seed, 100 + j, self.tr["patches_per_request"],
            self.tr["sample_lanes"]), device=device)

    def setup(self):
        import lyssandra_tpu_torch as lt

        cfg, tr = self.cfg, self.tr
        self.inputs()
        self.enc = lt.SparseEncoder(cfg["algorithm"], {"T": cfg["T"]},
                                    block=tr["block"])
        for i in range(tr["warmup_requests"]):
            self.enc.encode(self.pool[i % len(self.pool)], self.D,
                            dense=False)
        sync(self.devices)
        self.launches0 = launches()

    def request(self, i):
        X = self.pool[i % len(self.pool)]
        with span("encode"):
            res = self.enc.encode(X, self.D, dense=False)
            sync(self.devices)
        self.n += 1
        if i in self.keep:
            self.kept[i] = (i % len(self.pool), res)
        self.last = (i, i % len(self.pool), res)
        return X.shape[1]

    def window_closed(self):
        self.counters["launches_per_request"] = (launches()
                                                 - self.launches0) / self.n

    def after_window(self, trace):
        pass

    def free(self):
        """Keep the sampled lanes of the kept answers; drop the rest and
        the encoder."""
        i, k, res = self.last
        self.kept[i] = (k, res)
        out = []
        for j, (i, (k, res)) in enumerate(sorted(self.kept.items())):
            lanes = self.lanes(j, res.idx.device)
            out.append((k, lanes, [t[lanes].clone() for t in res]))
        self.sampled = out
        self.kept, self.last, self.enc = {}, None, None

    def check(self, ref):
        Xs, progs = [], []
        for k, lanes, prog in self.sampled:
            Xs.append(self.pool[k][:, lanes.to(self.pool[k].device)])
            progs.append(prog)
        X = torch.cat(Xs, dim=1).to(torch.float64)
        prog = [torch.cat([p[f] for p in progs]) for f in range(4)]
        self.pool = None
        got = ref.code(self.D, X, self.cfg)
        numbers = compare.codes(prog, got, X)
        self._count_work(got[0], got[3])
        return numbers

    def control(self, ref):
        """The check's numbers with the reference in the precision below
        the configuration's put in the program's place: it codes the
        lanes a run keeps of the requests drawn from the seed."""
        self.inputs()
        Xs = [self.pool[i % len(self.pool)][:, self.lanes(j, self.D.device)]
              for j, i in enumerate(sorted(self.keep))]
        X = torch.cat(Xs, dim=1).to(torch.float64)
        got = ref.code(self.D, X, self.cfg, control=True)
        return compare.codes(got, ref.code(self.D, X, self.cfg), X)

    def _count_work(self, idx, nsel):
        cfg, tr = self.cfg, self.tr
        p, K, T = cfg["p"], cfg["K"], cfg["T"]
        nsel = nsel.cpu().numpy()
        n_atoms = int(torch.unique(idx[idx >= 0]).numel())
        N, B = tr["patches_per_request"], tr["block"]
        self.work["call"] = work.encode_call(p, K, T, work.scale_nsel(nsel, N),
                                             n_atoms)
        blocks = -(-N // B)                  # one K1 launch a block
        f, b = work.omp_kernel(p, K, T, work.scale_nsel(nsel, B))
        self.work["k1"] = (blocks * f, blocks * b)
        self.work["k1_tag"] = "omp_fused_kernel"
