"""Each plain reference against a float64 NumPy computation written out
lane by lane (and atom by atom) at a tiny size."""

import numpy as np
import pytest
import torch

from portbench.reference import denoise as den
from portbench.reference.ksvd import ksvd_iteration
from portbench.reference.omp import dense, omp


def np_omp(D, x, T, eps=None):
    """OMP of one signal: (support in pick order, coefficients, ||r||^2)."""
    r, sup, g = x.copy(), [], np.zeros(0)
    for _ in range(T):
        if eps is not None and r @ r <= eps * eps:
            break
        k = int(np.argmax(np.abs(D.T @ r)))
        if k in sup:
            break
        sup.append(k)
        g = np.linalg.lstsq(D[:, sup], x, rcond=None)[0]
        r = x - D[:, sup] @ g
    return sup, g, float(r @ r)


def problem(seed, p=12, K=30, N=40):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0)
    return D, rng.standard_normal((p, N))


@pytest.mark.parametrize("eps", [None, 1.5])
def test_omp_against_numpy(eps):
    D, X = problem(0)
    idx, gamma, err, nsel = omp(torch.tensor(D), torch.tensor(X), 5, eps)
    for n in range(X.shape[1]):
        sup, g, e = np_omp(D, X[:, n], 5, eps)
        m = int(nsel[n])
        assert idx[n, :m].tolist() == sup
        assert (idx[n, m:] == -1).all() and (gamma[n, m:] == 0).all()
        np.testing.assert_allclose(gamma[n, :m].numpy(), g, rtol=1e-9,
                                   atol=1e-12)
        assert float(err[n]) == pytest.approx(e, rel=1e-9, abs=1e-12)
    if eps is not None:
        assert (nsel < 5).any() and (err[nsel < 5] <= eps * eps).all()


def test_omp_stops_on_a_repeated_atom():
    D = np.eye(4)[:, [0, 1, 0]]          # atom 2 is atom 0 again
    X = np.array([[1.0], [0.5], [0.0], [0.0]])
    idx, gamma, err, nsel = omp(torch.tensor(D), torch.tensor(X), 3)
    assert int(nsel[0]) == 2 and float(err[0]) == pytest.approx(0.0)


def test_dense():
    idx = torch.tensor([[2, 0], [1, -1]])
    gamma = torch.tensor([[1.0, 2.0], [3.0, 0.0]], dtype=torch.float64)
    assert dense(idx, gamma, 3).tolist() == [[2.0, 0.0], [0.0, 3.0],
                                             [1.0, 0.0]]


def test_dct_dictionary():
    D = den.dct_dictionary(8, 256)
    assert D.shape == (64, 256)
    np.testing.assert_allclose(np.linalg.norm(D, axis=0), 1.0, rtol=1e-12)
    np.testing.assert_allclose(D[:, 0], 1 / 8, rtol=1e-12)


def test_sampled_patches_as_a_loop():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (20, 17))
    X = den.sampled_patches(img, 4, 7, seed=3)
    r = np.random.default_rng(3)
    ii, jj = r.integers(0, 17, 8), r.integers(0, 14, 8)
    for n in range(7):
        v = img[ii[n]:ii[n] + 4, jj[n]:jj[n] + 4].reshape(-1)
        np.testing.assert_allclose(X[:, n], v - v.mean(), atol=1e-12)


def test_denoise_against_numpy():
    rng = np.random.default_rng(1)
    H, W, p, sigma = 11, 9, 3, 20.0
    y = rng.uniform(0, 255, (H, W))
    D = den.dct_dictionary(p, 16)
    out, nsel = den.denoise(torch.tensor(D), torch.tensor(y), p=p,
                            sigma=sigma, gain=1.15, lam=0.5, T_max=4)
    acc, cnt = np.zeros((H, W)), np.zeros((H, W))
    n = 0
    for i in range(H - p + 1):
        for j in range(W - p + 1):
            x = y[i:i + p, j:j + p].reshape(-1)
            mu = x.mean()
            sup, g, _ = np_omp(D, x - mu, 4, 1.15 * p * sigma)
            assert int(nsel[n]) == len(sup)
            n += 1
            xh = (D[:, sup] @ g if sup else 0.0) + mu
            acc[i:i + p, j:j + p] += np.reshape(xh, (p, p)) \
                if sup else mu
            cnt[i:i + p, j:j + p] += 1
    lam_w = 0.5 / sigma
    np.testing.assert_allclose(out.numpy(), (lam_w * y + acc)
                               / (lam_w + cnt), rtol=1e-10)


def test_ksvd_iteration_against_numpy():
    rng = np.random.default_rng(2)
    p, K, N, T, eps = 6, 10, 60, 3, 0.4
    D = rng.standard_normal((p, K))
    D /= np.linalg.norm(D, axis=0)
    D[:, 9] = D[:, 8]                     # coherent pair: atom 8 replaced
    X = rng.standard_normal((p, N))
    got, _ = ksvd_iteration(torch.tensor(X), torch.tensor(D), T=T, eps=eps)
    G = np.zeros((K, N))
    for n in range(N):
        sup, g, _ = np_omp(D, X[:, n], T, eps)
        G[sup, n] = g
    Dn = D.copy()
    for k in range(K):
        w = np.nonzero(G[k])[0]
        if w.size == 0:
            continue
        E = X[:, w] - Dn @ G[:, w] + np.outer(Dn[:, k], G[k, w])
        d = E @ G[k, w]
        d /= np.linalg.norm(d)
        Dn[:, k] = d
        G[k, w] = E.T @ d
    err = ((X - Dn @ G) ** 2).sum(axis=0)
    worst = sorted(range(N), key=lambda n: (-err[n], n))
    r = 0
    for k in range(K):
        used = np.count_nonzero(G[k])
        coh = max([abs(Dn[:, k] @ Dn[:, j]) for j in range(k + 1, K)],
                  default=0.0)
        if used < 1 or coh > 0.99:
            v = X[:, worst[r % min(K, N)]]
            Dn[:, k] = v / np.linalg.norm(v)
            r += 1
    Dn /= np.linalg.norm(Dn, axis=0)
    assert r >= 1
    np.testing.assert_allclose(got.numpy(), Dn, rtol=1e-9, atol=1e-12)
