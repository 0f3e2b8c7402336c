"""Expected Improvement and GP posterior over a batch of hyper samples.

JAX counterpart: ``spearmint_tpu/acquire/ei.py``.

    K     = amp2·(k(X,X) + jitter·I) + noise·I
    L     = chol(K);  α = K⁻¹ (y − mean);  B = L⁻¹ k(X, C)·amp2
    m(C)  = mean + k(X,C)ᵀ α
    v(C)  = amp2·(1 + jitter) − Σ B²
    EI    = √v · (u·Φ(u) + φ(u)),  u = (best − m)/√v

Every cache holds S samples on a leading axis (the JAX package vmapped
one cache per sample).  The factorizations come from kernels B2/B3
(core/linalg.cache_factor, factor_solve); the GEMMs against L⁻¹ are
``torch.matmul`` in full float32 (TF32 is off, package ``__init__``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from spearmint_tpu_torch.core import linalg
from spearmint_tpu_torch.core.kernels import matern52
from spearmint_tpu_torch.core.likelihood import (
    GPHypers,
    _effective_jitter,
    cross_cov,
    unit_cov_matrix,
)


class PosteriorCache(NamedTuple):
    """Per-sample factorizations reused across EI evaluations.

    ``alpha``/``best`` may carry a fantasy axis F after the sample axis
    ([S, F, N], [S, F]), in which case EI evaluations return [S, F, C]."""

    chol: torch.Tensor   # [S, N, N] lower Cholesky of the observation cov
    alpha: torch.Tensor  # [S, N] or [S, F, N]: K⁻¹(y − mean)
    best: torch.Tensor   # [S] or [S, F]: incumbent (min of values)
    hypers: GPHypers     # [S] samples
    linv: torch.Tensor | None = None  # [S, N, N] explicit L⁻¹, optional


def _factor_inputs(x, mask, hypers: GPHypers, kernel):
    m0 = unit_cov_matrix(x, mask, hypers.ls, kernel)
    dadd = torch.where(mask, hypers.noise[:, None], 1.0)
    return m0, dadd


def make_cache(x, y, mask, hypers: GPHypers, kernel: Callable = matern52,
               with_inverse: bool = False) -> PosteriorCache:
    """Factor every sample through the same shifted form the sampler
    evaluated it with (B2, and B3 for L⁻¹)."""
    m0, dadd = _factor_inputs(x, mask, hypers, kernel)
    resid = torch.where(mask, y - hypers.mean[:, None], 0.0)
    if with_inverse:
        chol, linv, alpha = linalg.cache_factor(m0, hypers.amp2, dadd, resid)
    else:
        chol, alpha = linalg.factor_solve(m0, hypers.amp2, dadd, resid)
        linv = None
    best = linalg.masked_min(y, mask).expand(alpha.shape[0])
    return PosteriorCache(chol=chol, alpha=alpha, best=best, hypers=hypers,
                          linv=linv)


def make_cache_aug(x_aug, mask_aug, y_augs, hypers: GPHypers,
                   kernel: Callable = matern52,
                   with_inverse: bool = True) -> PosteriorCache:
    """Cache over augmented (obs ∪ pend) data with a fantasy axis:
    y_augs [S, F, N+P].  The F draws of a sample share its one
    factorization; α_f = K⁻¹r_f is two GEMMs against L⁻¹, or two
    triangular solves without the inverse."""
    m0, dadd = _factor_inputs(x_aug, mask_aug, hypers, kernel)
    resid = torch.where(mask_aug, y_augs - hypers.mean[:, None, None], 0.0)
    if with_inverse:
        chol, linv, _ = linalg.cache_factor(m0, hypers.amp2, dadd,
                                            resid[:, 0])
        w = linv @ resid.mT                                # [S, N+P, F]
        alpha = (linv.mT @ w).mT                           # [S, F, N+P]
    else:
        chol, _ = linalg.factor_solve(m0, hypers.amp2, dadd, resid[:, 0])
        linv = None
        alpha = linalg.chol_solve(chol, resid.mT).mT
    best = torch.where(mask_aug, y_augs, float("inf")).amin(-1)  # [S, F]
    return PosteriorCache(chol=chol, alpha=alpha, best=best, hypers=hypers,
                          linv=linv)


def posterior_from_cache(cache: PosteriorCache, x, mask, cand,
                         kernel: Callable = matern52):
    """Posterior mean [S, C] (or [S, F, C]) and variance [S, C] at cand."""
    h = cache.hypers
    kx = cross_cov(x, cand, h.amp2, h.ls, kernel) * mask[:, None]
    if cache.alpha.ndim == 3:
        mu = h.mean[:, None, None] + cache.alpha @ kx
    else:
        mu = h.mean[:, None] + (cache.alpha[:, None, :] @ kx)[:, 0]
    if cache.linv is not None:
        beta = cache.linv @ kx
    else:
        beta = linalg.tri_solve(cache.chol, kx)
    # prior variance with the same jitter the covariance was assembled with
    var = (h.amp2[:, None] * (1.0 + _effective_jitter(x.shape[0]))
           - (beta * beta).sum(-2))
    return mu, var


def _ei_from_moments(mu, var, best):
    sigma = torch.sqrt(torch.clamp_min(var, 1e-14))
    if mu.ndim == 3:   # fantasy axis: mu [S, F, C], var [S, C], best [S, F]
        sigma = sigma[:, None, :]
    u = (best[..., None] - mu) / sigma
    ncdf = torch.special.ndtr(u)
    npdf = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return sigma * (u * ncdf + npdf)


def ei_from_cache(cache: PosteriorCache, x, mask, cand,
                  kernel: Callable = matern52) -> torch.Tensor:
    """EI [S, C] (or [S, F, C]) reusing the cached factorizations."""
    mu, var = posterior_from_cache(cache, x, mask, cand, kernel)
    return _ei_from_moments(mu, var, cache.best)


def ei_from_cache_chunked(cache: PosteriorCache, x, mask, cand,
                          kernel: Callable = matern52,
                          chunk: int = 512) -> torch.Tensor:
    """EI over a large candidate set, ``chunk`` candidates at a time to
    bound the [S, N, chunk] temporaries.  Same values as unchunked."""
    parts = [ei_from_cache(cache, x, mask, cand[i:i + chunk], kernel)
             for i in range(0, cand.shape[0], chunk)]
    return torch.cat(parts, dim=-1)
