"""K-SVD learning (config 2's route: fixed-T Batch-OMP codes, the B=1
sweep, the replacement rule) against the benchmark's plain reference
(``portbench/reference/ksvd.py`` and its coding/sweep split
``ksvd_sweep.py``, float64, no import of the port) on the CPU at a small
size: p = 16 (4x4 patches of 32x32 images), K = 32, T = 4, N = 800, 3
iterations from the 'data' start.  Each iteration is held from the
program's own dictionary in: the codes by each lane's residual energy
against the reference's OMP, the atoms after the sweep and the
replacement atom by atom, and the iteration as a whole against
``ksvd_iteration`` in fixed-T mode."""

import importlib

import numpy as np
import pytest
import torch

import lyssandra_tpu_torch as lt
from lyssandra_tpu_torch.utils import patch_dataset, standard_test_image
from portbench.core import spec
from portbench.reference.ksvd import ksvd_iteration
from portbench.reference.omp import dense, omp

tksvd = importlib.import_module("lyssandra_tpu_torch.dict_learning.ksvd")

torch.set_num_threads(1)

P, K, T, N, ITERS = 16, 32, 4, 800, 3
CFG = {"K": K, "T": T, "seed": 0, "min_use": 1, "max_coherence": 0.99}
REF = spec.load_module(spec.BENCH / "configs" / "ksvd-c2.py",
                       "portbench_ref_ksvd_c2")


def _signals():
    imgs = [standard_test_image(n, 32) for n in ("barbara", "lena")]
    X = patch_dataset(imgs, p=4, n_patches=N, seed=6)
    return torch.from_numpy(X.astype(np.float32))


class Recorder:
    """Wraps ``ksvd_step``: keeps (X, D in, D out, stats) of each call and
    the codes the learner's encoder handed it."""

    def __init__(self, monkeypatch, learner):
        self.calls, self.codes = [], None
        real, encode = tksvd.ksvd_step, learner.encoder.encode

        def step(X, D, *a, **kw):
            out = real(X, D, *a, **kw)
            self.calls.append((X, D, out[0], self.codes, out[-1]))
            return out

        def keep(*a, **kw):
            self.codes = encode(*a, **kw)
            return self.codes

        monkeypatch.setattr(tksvd, "ksvd_step", step)
        learner.encoder.encode = keep


def _fit(monkeypatch):
    learner = lt.KSVDLearner(lt.KSVDConfig(K=K, T=T, n_iter=ITERS),
                             device="cpu")
    rec = Recorder(monkeypatch, learner)
    X = _signals()
    learner.fit(X)
    return X, learner, rec.calls


def _energy_gaps(X, D, G):
    """|program's ||x - D gamma||^2 - the reference OMP's| per lane, over
    ||x||^2 floored at 1e-10 of its mean (the benchmark's reading)."""
    Xd, Dd, Gd = X.double(), D.double(), G.double()
    R = Xd - Dd @ Gd
    _, err, _ = REF.code(Xd, Dd, CFG)
    xn = (Xd * Xd).sum(dim=0)
    return ((R * R).sum(dim=0) - err).abs() / xn.clamp_min(
        1e-10 * float(xn.mean()))


def test_data_start_is_the_references_draw_bit_for_bit(monkeypatch):
    X, _, calls = _fit(monkeypatch)
    assert torch.equal(calls[0][1], REF.dictionary(X, CFG))


@pytest.mark.parametrize("part", ["codes", "atoms", "iteration", "stats"])
def test_each_iteration_against_the_reference(monkeypatch, part):
    X, learner, calls = _fit(monkeypatch)
    assert len(calls) == ITERS
    assert torch.equal(learner.D_, calls[-1][2])
    for (Xi, Din, Dout, G, st), nxt in zip(calls, calls[1:] + [None]):
        assert torch.equal(Xi, X)
        if nxt is not None:
            assert torch.equal(nxt[1], Dout)
        if part == "codes":
            gaps = _energy_gaps(X, Din, G)
            assert float(gaps.max()) < 1e-4 and float(gaps.median()) < 1e-9
        elif part == "atoms":
            D_ref, _ = REF.from_codes(X, Din, G, CFG)
            gaps = torch.linalg.vector_norm(Dout.double() - D_ref, dim=0)
            assert float(gaps.max()) < 1e-5, float(gaps.max())
        elif part == "iteration":
            # the reference's own codes: where a pick parts on a near tie,
            # the atoms it touches part with it, so most atoms agree
            D_ref, nsel = ksvd_iteration(X.double(), Din.double(), T=T,
                                         eps=None)
            gaps = torch.linalg.vector_norm(Dout.double() - D_ref, dim=0)
            assert bool((nsel <= T).all())
            assert float(gaps.median()) < 1e-5, float(gaps.median())
        else:
            _, st_ref = REF.from_codes(X, Din, G, CFG)
            np.testing.assert_allclose(st.double().numpy(), st_ref.numpy(),
                                       rtol=1e-5)


def test_replacement_ran_at_this_size(monkeypatch):
    # the case above holds the replacement only where an atom is bad:
    # 2 in each of the first two iterations at this size
    _, _, calls = _fit(monkeypatch)
    assert sum(int(c[4][3]) for c in calls) >= 1


def test_planted_skipped_sweep_fails(monkeypatch):
    # the sweep taken out: the atoms part from the reference's by far
    # more than the 1e-5 the case above holds them to
    monkeypatch.setattr(tksvd, "ksvd_atom_update",
                        lambda X, D, Gamma, **kw: (D.clone(), Gamma.clone()))
    X, _, calls = _fit(monkeypatch)
    Xi, Din, Dout, G, _ = calls[0]
    D_ref, _ = REF.from_codes(X, Din, G, CFG)
    assert float(torch.linalg.vector_norm(Dout.double() - D_ref,
                                          dim=0).max()) > 1e-2


def test_fixed_t_reference_codes_every_lane_to_t(rng):
    # the reference OMP in fixed-T mode on well-posed lanes: T atoms a
    # lane, and the dense codes rebuild the error it reports
    D = torch.from_numpy(rng.standard_normal((P, K)))
    D = D / torch.linalg.vector_norm(D, dim=0)
    X = torch.from_numpy(rng.standard_normal((P, 64)))
    idx, gamma, err, nsel = omp(D, X, T)
    assert bool((nsel == T).all())
    R = X - D @ dense(idx, gamma, K)
    np.testing.assert_allclose((R * R).sum(dim=0).numpy(), err.numpy(),
                               rtol=1e-9)
