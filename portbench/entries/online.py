"""Entry ``online``: config 4's ``OnlineDictionaryLearner`` (coder
"feature_sign"), one learning task a request, every task from the same
warm state.  The mix's ``mode`` says which call a task is:

- "fit": ``fit(X_task, n_epochs=1, holdout=X_hold)`` over
  ``minibatches_per_task`` pool minibatches (one chunk; the in-loop coder
  ``feature_sign_scan``, the sweep, the holdout metric);
- "stream": ``partial_fit(Xb)`` of one pool minibatch (``feature_sign``
  with its cold start, the sweep).

The patches are made once from the configuration's ``data_seed`` (the
same for every seed) and cut into the epoch's minibatches in the order of
numpy's default_rng(epoch_seed): the first ``warmup_minibatches`` are the
warm-up (a fit over them, or a partial_fit of each), the rest the pool of
tasks, cycled in an order drawn from the run's seed.  Before each task the
learner is put back in the state the warm-up left, so a task's work does
not depend on the tasks before it.

The check follows one task, drawn from the seed among the first
``sample_span``, minibatch by minibatch: the harness wraps the program's
per-minibatch update (``dict_learning.online.minibatch_update``, called
once a minibatch by ``fit`` and ``partial_fit`` with (D, A, B, Xb, ...)
and returning (D, A, B, Gamma)) and, for that task alone, keeps each
minibatch's state in, signals and results.  The reference holds the codes
by their objective against its lasso optimum and by the KKT conditions
(config 4's data dictionary has near-duplicate atoms, so float32 and
float64 optima differ in support on about a tenth of the lanes), A and B
from the program's codes, the swept D atom by atom from the program's own
D, A and B, and the task's recorded objectives from the program's D out.
The name ``minibatch_update`` is therefore part of the benchmark's
contract with the program."""

import importlib

import numpy as np
import torch

from portbench.core import compare
from portbench.core.program import sync
from portbench.core.trace import span
from portbench.yardstick import color, generate, lasso_work

STEP = "minibatch_update"
CODES = ("obj_gap_max", "obj_gap_median", "kkt_max", "kkt_median")


class Entry:
    unit = "tasks"

    def __init__(self, cell, seed, devices):
        self.cfg, self.tr = cell.config, cell.traffic
        self.mode = self.tr["mode"]
        if self.mode not in ("fit", "stream"):
            raise ValueError(f"mode {self.mode!r}")
        self.seed = seed
        self.devices = devices
        self.counters = {}
        self.work = {}
        self.recording = None
        self.recorded = None
        self.follow_index = int(generate.sample_indices(
            seed, 5, self.tr["sample_span"], 1)[0])
        # the window runs until the followed task is done
        self.min_requests = self.follow_index + 1

    def inputs(self):
        """The warm-up's minibatches, the pool of tasks, its order and the
        holdout set, on the card."""
        cfg, tr, dev = self.cfg, self.tr, self.devices[0]
        X = torch.from_numpy(color.unit_patches(cfg)).to(dev)
        n, bs = cfg["n_train"], cfg["batch_size"]
        self.holdout = X[:, n:]
        perm = np.random.default_rng(cfg["epoch_seed"]).permutation(n)
        mbs = [X[:, torch.from_numpy(perm[j * bs:(j + 1) * bs]).to(dev)]
               for j in range(n // bs)]
        w, per = tr["warmup_minibatches"], tr["minibatches_per_task"]
        self.warm_mbs = mbs[:w]
        pool = mbs[w:]
        self.tasks = [torch.cat(pool[i * per:(i + 1) * per], dim=1)
                      for i in range(min(tr["pool"], len(pool) // per))]
        self.order = np.arange(len(self.tasks))
        generate.shuffle(self.order, self.seed)

    def expected(self, X):
        """The minibatches a task over X codes, in order: ``fit``'s
        permutation of its columns (numpy's default_rng(0), fit's seed),
        or X itself."""
        if self.mode == "stream":
            return [X]
        bs = self.cfg["batch_size"]
        perm = torch.from_numpy(np.random.default_rng(0).permutation(
            X.shape[1])).to(X.device)
        return [X[:, perm[j * bs:(j + 1) * bs]]
                for j in range(X.shape[1] // bs)]

    def _wrap(self, step):
        def wrapped(D, A, B, Xb, *args, **kw):
            out = step(D, A, B, Xb, *args, **kw)
            if self.recording is not None:
                self.recording.append((D, A, B, Xb) + tuple(out))
            return out
        return wrapped

    def setup(self):
        import lyssandra_tpu_torch as lt

        cfg = self.cfg
        self.online = importlib.import_module(
            "lyssandra_tpu_torch.dict_learning.online")
        self.orig = getattr(self.online, STEP, None)
        if not callable(self.orig):
            raise RuntimeError(
                "lyssandra_tpu_torch.dict_learning.online has no "
                f"{STEP}, the per-minibatch update this cell's check "
                "follows")
        setattr(self.online, STEP, self._wrap(self.orig))
        self.inputs()
        self.learner = lt.OnlineDictionaryLearner(lt.OnlineDLConfig(
            K=cfg["K"], lam=cfg["lam"], batch_size=cfg["batch_size"],
            n_sweeps=cfg["n_sweeps"], beta=cfg["beta"],
            chunk_batches=cfg["chunk_batches"],
            fs_max_active=cfg["fs_max_active"],
            fs_max_iter=cfg["fs_max_iter"], fs_max_inner=cfg["fs_max_inner"],
            fs_cold_unroll=cfg["fs_cold_unroll"],
            code_blocks=cfg["code_blocks"], seed=cfg["init_seed"]),
            device=self.devices[0])
        if self.mode == "fit":
            self.learner.fit(torch.cat(self.warm_mbs, dim=1), n_epochs=1,
                             holdout=self.holdout)
        else:
            for Xb in self.warm_mbs:
                self.learner.partial_fit(Xb)
        sync(self.devices)
        self.warm_state = st = self.learner.state
        self.warm = (st.D, st.A, st.B)

    def _task(self, k):
        L = self.learner
        L.state = self.warm_state
        L.history_ = []
        if self.mode == "fit":
            L.fit(self.tasks[k], n_epochs=1, holdout=self.holdout)
        else:
            L.partial_fit(self.tasks[k])

    def request(self, i):
        k = int(self.order[i % len(self.order)])
        self.recording = [] if i == self.follow_index else None
        with span("online_" + self.mode):
            self._task(k)
            sync(self.devices)
        if self.recording is not None:
            st = self.learner.state
            self.recorded = (k, self.recording, (st.D, st.A, st.B),
                             list(self.learner.history_))
            self.recording = None
        return 1

    def window_closed(self):
        pass

    def after_window(self, trace):
        pass

    def free(self):
        setattr(self.online, STEP, self.orig)
        self.learner = None

    def check(self, ref):
        if self.recorded is None:           # the followed task failed
            return self.follow(ref, 0, [], None, [])
        return self.follow(ref, *self.recorded)

    def follow(self, ref, k, recs, final, hist):
        """The numbers of one task on pool entry k: its minibatches
        ``recs`` ((D, A, B, Xb in; D, A, B, Gamma out) each), the state
        it left ``final`` (D, A, B) and its history ``hist``."""
        cfg, want = self.cfg, self.tr["minibatches_per_task"]
        names = ("minibatches_missing", "input_gap", "state_gap") + CODES + (
            "stats_gap", "atom_gap_max", "atom_gap_median", "batch_obj_gap")
        if self.mode == "fit":
            names += ("holdout_gap",)
        if not recs or not hist:
            return dict.fromkeys(names, float("inf")) | {
                "minibatches_missing": float(want)}
        # the start: the warm state, the task's signals, each minibatch
        # from the one before, and the state the task left, bit for bit
        inputs = [compare.max_abs(a, b) for a, b in zip(recs[0][:3],
                                                        self.warm)]
        inputs += [compare.max_abs(r[3], x) for r, x in zip(
            recs, self.expected(self.tasks[k]))]
        inputs += [compare.max_abs(b[i], a[4 + i]) for a, b in zip(
            recs, recs[1:]) for i in range(3)]
        state = [compare.max_abs(final[i], recs[-1][4 + i])
                 for i in range(3)]
        obj, kkt, stats, atoms, nnzs = [], [], [], [], []
        for D, A, B, Xb, Dn, An, Bn, Gamma in recs:
            G_ref, _ = ref.lasso(D, Xb, cfg)
            f_ref = ref.objective(D, Xb, G_ref, cfg)
            f = ref.objective(D, Xb, Gamma, cfg)
            obj.append((f - f_ref) / f_ref.clamp_min(1e-30))
            kkt.append(ref.kkt(D, Xb, Gamma, cfg))
            nnzs.append((G_ref != 0).sum(dim=0).cpu().numpy())
            A_ref, B_ref = ref.statistics(A, B, Xb, Gamma, cfg)
            stats += [_rel(An, A_ref), _rel(Bn, B_ref)]
            atoms.append(compare.atoms(Dn, ref.sweep(D, An, Bn, cfg)))
        obj, kkt, atoms = torch.cat(obj), torch.cat(kkt), torch.cat(atoms)
        Gamma, Xb = recs[-1][7], recs[-1][3]
        f_batch = ref.batch_objective(final[0], Xb, Gamma, cfg)
        out = {
            "minibatches_missing": float(abs(len(recs) - want)),
            "input_gap": max(inputs),
            "state_gap": max(state),
            "obj_gap_max": float(obj.max()),
            "obj_gap_median": float(obj.median()),
            "kkt_max": float(kkt.max()),
            "kkt_median": float(kkt.median()),
            "stats_gap": max(stats),
            "atom_gap_max": float(atoms.max()),
            "atom_gap_median": float(atoms.median()),
            "batch_obj_gap": abs(hist[-1]["batch_objective"] - f_batch)
            / abs(f_batch),
        }
        p, K = Xb.shape[0], cfg["K"]
        if self.mode == "fit":
            f_hold = ref.holdout_objective(final[0], self.holdout, cfg)
            out["holdout_gap"] = abs(hist[-1]["holdout_objective"]
                                     - f_hold) / abs(f_hold)
            self.work["call"] = lasso_work.task(
                p, K, nnzs, self.holdout.shape[1], cfg["holdout_iters"])
        else:
            self.work["call"] = lasso_work.task(p, K, nnzs)
            self.work["k6"] = lasso_work.fs_cold_kernel(
                K, cfg["stream_cold_unroll"], nnzs[0],
                int((G_ref != 0).any(dim=1).sum()))
            self.work["k6_tag"] = "fs_cold_kernel"
        return out

    def control(self, ref):
        """The check's numbers with the reference in the precision below
        the configuration's doing the followed task in the program's
        place, from a warm state of its own: a data dictionary drawn from
        the warm-up's first minibatch, then the warm-up's minibatches."""
        cfg = self.cfg
        self.inputs()
        warm = self.warm_mbs
        if self.mode == "fit":
            warm = self.expected(torch.cat(warm, dim=1))
        D = ref.init_dictionary(warm[0], cfg, control=True)
        A = torch.zeros((cfg["K"], cfg["K"]), dtype=D.dtype, device=D.device)
        B = torch.zeros_like(D)
        for Xb in warm:
            D, A, B, _ = _step(ref, cfg, D, A, B, Xb)
        self.warm = (D, A, B)
        k = int(self.order[self.follow_index % len(self.order)])
        recs = []
        for Xb in self.expected(self.tasks[k]):
            out = _step(ref, cfg, D, A, B, Xb)
            recs.append((D, A, B, Xb) + out)
            D, A, B = out[:3]
        hist = {"batch_objective": ref.batch_objective(
            D, recs[-1][3], recs[-1][7], cfg, control=True)}
        if self.mode == "fit":
            hist["holdout_objective"] = ref.holdout_objective(
                D, self.holdout, cfg, control=True)
        return self.follow(ref, k, recs, (D, A, B), [hist])


def _step(ref, cfg, D, A, B, Xb):
    """One minibatch of the reference in the control's precision."""
    Gamma, _ = ref.lasso(D, Xb, cfg, control=True)
    A, B = ref.statistics(A, B, Xb, Gamma, cfg, control=True)
    return ref.sweep(D, A, B, cfg, control=True), A, B, Gamma


def _rel(prog, want):
    """max |prog - want| over max |want|, in want's dtype."""
    d = (prog.to(want.dtype) - want).abs().max()
    return float(d / want.abs().max().clamp_min(1e-30))
