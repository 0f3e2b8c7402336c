"""Pending-job fantasization (asynchronous parallel BO).

JAX counterpart: ``spearmint_tpu/acquire/fantasy.py`` (``fantasize_batch``).
For every hyperparameter sample, draw the pending jobs' outcomes from the
GP posterior (a noise-free function draw); the caller appends them to the
observed data and computes EI on the augmented set.

The standard normals are an argument, so a test can feed the JAX function
and this one the same draws.
"""

from __future__ import annotations

from typing import Callable

import torch

from spearmint_tpu_torch.core import linalg
from spearmint_tpu_torch.core.kernels import matern52
from spearmint_tpu_torch.core.likelihood import (
    GPHypers,
    JITTER,
    cross_cov,
    unit_cov_matrix,
)


def pending_posterior(x, y, mask, pend, pend_mask, hypers: GPHypers,
                      kernel: Callable = matern52):
    """Posterior mean [S, P] and jittered covariance [S, P, P] (identity on
    padded rows) of the pending points, one per sample of ``hypers`` [S].

    The observation factorization goes through the sampler's own shifted
    form (kernel B2 via linalg.factor_solve)."""
    n_pend = pend.shape[0]
    m0 = unit_cov_matrix(x, mask, hypers.ls, kernel)
    dadd = torch.where(mask, hypers.noise[:, None], 1.0)
    resid = torch.where(mask, y - hypers.mean[:, None], 0.0)
    obs_chol, alpha = linalg.factor_solve(m0, hypers.amp2, dadd, resid)

    kx = cross_cov(x, pend, hypers.amp2, hypers.ls, kernel) * mask[:, None]
    eye_p = torch.eye(n_pend, dtype=x.dtype, device=x.device)
    kappa = hypers.amp2[:, None, None] * (kernel(pend, pend, hypers.ls)
                                          + JITTER * eye_p)
    pend_m = hypers.mean[:, None] + (alpha[:, None, :] @ kx)[:, 0]   # [S, P]
    beta = linalg.tri_solve(obs_chol, kx)                            # [S, N, P]
    pend_k = kappa - beta.mT @ beta
    return pend_m, linalg.mask_psd_matrix(pend_k + JITTER * eye_p, pend_mask)


def fantasize_batch(draws: torch.Tensor, x, y, mask, pend, pend_mask,
                    hypers: GPHypers,
                    kernel: Callable = matern52) -> torch.Tensor:
    """[S, F, P] fantasy values (0 where ~pend_mask) from standard normal
    draws [S, F, P], one posterior per sample of ``hypers`` [S].

    The P×P pending factorization stays a library Cholesky by design (P
    pads to a few hundred at most); a sample whose pending covariance is
    not positive definite gets NaN fantasies."""
    pend_m, pend_k = pending_posterior(x, y, mask, pend, pend_mask, hypers,
                                       kernel)
    pend_chol = linalg.cholesky(pend_k)
    fant = pend_m[:, None, :] + draws @ pend_chol.mT
    return torch.where(pend_mask, fant, 0.0)
