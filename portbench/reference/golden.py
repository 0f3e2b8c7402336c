"""Frozen float64 NumPy/SciPy copy of the GP-EI math (log marginal,
posterior, EI) from the reference package's golden module.

It is a copy, not an import: the benchmark never loads that package.  The
tests hold ``reference/gp.py`` (plain PyTorch, the one the benchmark runs)
to these functions at a tiny size.  Single sample, unpadded, as written
from the math: K = amp2·(k(X, X) + jitter·I) + noise·I.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as spla
import scipy.stats as sps

JITTER = 1e-6


def ard_sqdist(x1, x2, ls):
    a = x1 / ls
    b = x2 / ls
    diff = a[:, None, :] - b[None, :, :]
    return np.maximum(np.sum(diff * diff, axis=-1), 0.0)


def matern52(x1, x2, ls):
    r2 = ard_sqdist(x1, x2, ls)
    r = np.sqrt(r2)
    s5 = np.sqrt(5.0)
    return (1.0 + s5 * r + (5.0 / 3.0) * r2) * np.exp(-s5 * r)


def log_marginal(x, y, mean, amp2, noise, ls, jitter=JITTER):
    """GP log marginal without the −(n/2)·log 2π constant."""
    n = x.shape[0]
    cov = amp2 * (matern52(x, x, ls) + jitter * np.eye(n)) + noise * np.eye(n)
    try:
        chol = spla.cholesky(cov, lower=True)
    except spla.LinAlgError:
        return -np.inf
    resid = y - mean
    solve = spla.cho_solve((chol, True), resid)
    return -np.sum(np.log(np.diag(chol))) - 0.5 * np.dot(resid, solve)


def posterior(comp, vals, cand, mean, amp2, noise, ls, jitter=JITTER):
    n = comp.shape[0]
    obs_cov = amp2 * (matern52(comp, comp, ls) + jitter * np.eye(n)) + (
        noise * np.eye(n))
    obs_chol = spla.cholesky(obs_cov, lower=True)
    kx = amp2 * matern52(comp, cand, ls)
    alpha = spla.cho_solve((obs_chol, True), vals - mean)
    mu = mean + kx.T @ alpha
    beta = spla.solve_triangular(obs_chol, kx, lower=True)
    var = amp2 * (1.0 + jitter) - np.sum(beta * beta, axis=0)
    return mu, var


def compute_ei(comp, vals, cand, mean, amp2, noise, ls, jitter=JITTER):
    """EI for minimisation against the best (lowest) observed value."""
    best = np.min(vals)
    mu, var = posterior(comp, vals, cand, mean, amp2, noise, ls, jitter)
    sigma = np.sqrt(np.maximum(var, 1e-14))
    u = (best - mu) / sigma
    return sigma * (u * sps.norm.cdf(u) + sps.norm.pdf(u))
