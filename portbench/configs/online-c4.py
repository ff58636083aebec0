"""Plain reference of configuration online-c4: online dictionary learning
with lasso codes (reference/online.py) in float64; ``control=True`` runs
it in float32 with TF32 products, the precision just below the
configuration's."""

import torch

from portbench.reference import online as ref
from portbench.reference.omp import tf32


def _dt(control):
    return torch.float32 if control else torch.float64


def _cast(control, *ts):
    return [t.to(_dt(control)) for t in ts]


def lasso(D, X, cfg, control=False):
    """(Gamma (K, n), done (n,)): the lasso optimum of every column."""
    D, X = _cast(control, D, X)
    with tf32(control):
        return ref.lasso(D, X, cfg["lam"])


def objective(D, X, Gamma, cfg):
    """f per lane, in float64."""
    return ref.objective(*_cast(False, D, X, Gamma), cfg["lam"])


def kkt(D, X, Gamma, cfg):
    """The KKT breach per lane over lam, in float64."""
    return ref.kkt(*_cast(False, D, X, Gamma), cfg["lam"])


def statistics(A, B, X, Gamma, cfg, control=False):
    """(A, B) after one minibatch."""
    A, B, X, Gamma = _cast(control, A, B, X, Gamma)
    with tf32(control):
        return ref.statistics(A, B, X, Gamma, cfg["beta"])


def sweep(D, A, B, cfg, control=False):
    """D after the minibatch's atom sweeps."""
    D, A, B = _cast(control, D, A, B)
    with tf32(control):
        return ref.sweep(D, A, B, cfg["n_sweeps"])


def batch_objective(D, X, Gamma, cfg, control=False):
    """The minibatch's objective, summed over its lanes."""
    D, X, Gamma = _cast(control, D, X, Gamma)
    with tf32(control):
        return float(ref.objective(D, X, Gamma, cfg["lam"]).sum())


def holdout_objective(D, Xh, cfg, control=False):
    """The learner's holdout metric: the mean objective of FISTA codes."""
    D, Xh = _cast(control, D, Xh)
    with tf32(control):
        return float(ref.holdout_objective(D, Xh, cfg["lam"],
                                           cfg["holdout_iters"]))


def init_dictionary(X, cfg, control=False):
    """A data dictionary drawn from the columns of X (the control's
    start)."""
    return ref.init_dictionary(X.to(_dt(control)), cfg["K"],
                               cfg["init_seed"])
