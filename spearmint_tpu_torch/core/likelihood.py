"""GP log-marginal likelihood (the slice-sampling hot path).

JAX counterpart: ``spearmint_tpu/core/likelihood.py``.  The reference
formula, without the constant −(n/2)·log 2π:

    K    = amp2 · (kernel(ls, X) + jitter·I) + noise·I
    lp   = −Σ log diag chol(K) − ½ (y − mean)ᵀ K⁻¹ (y − mean)

Hyperparameters carry a leading batch axis (one entry per chain or
sample); every function here evaluates the whole batch at once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from spearmint_tpu_torch.core import linalg
from spearmint_tpu_torch.core.kernels import matern52

JITTER = 1e-6


class GPHypers(NamedTuple):
    """GP hyperparameter states, leading batch axis K on every field."""

    mean: torch.Tensor   # [K]
    amp2: torch.Tensor   # [K] signal variance
    noise: torch.Tensor  # [K] observation noise variance
    ls: torch.Tensor     # [K, D] ARD length scales


def _effective_jitter(n: int) -> float:
    """Reference jitter (1e-6) plus an f32-conditioning term at large n
    (0 below n=2048): cond(K) ≈ n/noise reaches the f32 failure edge."""
    return JITTER + 2e-7 * max(0, n - 2048)


def cov_matrix(x, mask, amp2, noise, ls, kernel: Callable = matern52):
    """amp2·(k(X,X) + jitter·I) + noise·I with padded rows/cols → identity.

    amp2, noise: [K]; ls: [K, D] → [K, N, N]."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = (amp2[:, None, None] * (kernel(x, x, ls) + _effective_jitter(n) * eye)
         + noise[:, None, None] * eye)
    return linalg.mask_psd_matrix(k, mask)


def unit_cov_matrix(x, mask, ls, kernel: Callable = matern52):
    """M = k(X,X) + jitter·I with padded rows/cols zeroed, [..., N, N].

    K = amp2·M + diag(where(mask, noise, 1)); every marginal evaluation and
    every posterior-cache factorization assembles through this M-form."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    both = mask[:, None] & mask[None, :]
    return torch.where(both, kernel(x, x, ls) + _effective_jitter(n) * eye,
                       0.0)


def cross_cov(x1, x2, amp2, ls, kernel: Callable = matern52):
    """amp2·k(X1, X2), no jitter; amp2 [K], ls [K, D] → [K, n, m]."""
    return amp2[..., None, None] * kernel(x1, x2, ls)


def log_marginal(x, y, mask, hypers: GPHypers,
                 kernel: Callable = matern52) -> torch.Tensor:
    """Reference GP log-marginal (sans 2π constant) per lane, [K].

    One B1 evaluation of the shifted form (linalg.fma_logdet_q); a failed
    (non-PD) factorization gives NaN, which becomes −inf here."""
    m0 = unit_cov_matrix(x, mask, hypers.ls, kernel)
    dadd = torch.where(mask, hypers.noise[:, None], 1.0)
    resid = torch.where(mask, y - hypers.mean[:, None], 0.0)
    ld, q = linalg.fma_logdet_q(m0, hypers.amp2, dadd, resid)
    lp = -ld - 0.5 * q
    return torch.where(torch.isnan(lp), float("-inf"), lp)
