"""Plain reference of configuration lasso-c4: lasso codes by feature-sign
search (reference/online.py's ``lasso``) in float64 over a dictionary
handed in, like a model's weights; ``control=True`` codes in float32 with
TF32 products, the precision just below the configuration's.  The
objective and the KKT breach are always taken in float64.

``learn`` makes that dictionary: the plain online learner of Mairal et
al. 2010 (reference/online.py: feature-sign codes, A and B, one
Gauss-Seidel sweep a minibatch) in float64, independent of the program."""

import numpy as np
import torch

from portbench.reference import online as ref
from portbench.reference.omp import tf32


def _dt(control):
    return torch.float32 if control else torch.float64


def _cast(control, *ts):
    return [t.to(_dt(control)) for t in ts]


def lasso(D, X, cfg, control=False):
    """(Gamma (K, n), done (n,)): the lasso optimum of every column of X
    over D at the configuration's lam."""
    D, X = _cast(control, D, X)
    with tf32(control):
        return ref.lasso(D, X, cfg["lam"])


def objective(D, X, Gamma, cfg):
    """f per lane, in float64."""
    return ref.objective(*_cast(False, D, X, Gamma), cfg["lam"])


def kkt(D, X, Gamma, cfg):
    """The KKT breach per lane over lam, in float64."""
    return ref.kkt(*_cast(False, D, X, Gamma), cfg["lam"])


def learn(X, cfg):
    """D (p, K) in float64: one epoch of the online learner over the
    training set X (p, n), its n // batch_size minibatches in the order
    of numpy's default_rng(epoch_seed), from K columns of X drawn with
    init_seed and A, B zero."""
    X = X.to(torch.float64)
    p, n = X.shape
    K, bs = cfg["K"], cfg["batch_size"]
    D = ref.init_dictionary(X, K, cfg["init_seed"])
    A = torch.zeros((K, K), dtype=X.dtype, device=X.device)
    B = torch.zeros((p, K), dtype=X.dtype, device=X.device)
    perm = torch.from_numpy(np.random.default_rng(
        cfg["epoch_seed"]).permutation(n)).to(X.device)
    for j in range(n // bs):
        Xb = X[:, perm[j * bs:(j + 1) * bs]]
        Gamma, _ = ref.lasso(D, Xb, cfg["lam"])
        A, B = ref.statistics(A, B, Xb, Gamma, cfg["beta"])
        D = ref.sweep(D, A, B, cfg["n_sweeps"])
    return D
