"""Covariance kernels: Matérn-5/2 / Matérn-3/2 / squared-exponential, ARD.

JAX counterpart: ``spearmint_tpu/core/kernels.py``.  Gradients w.r.t. the
inputs come from ``torch.autograd`` through these functions.

``ls`` may carry leading batch axes ([..., D]); the result then has them
too ([..., n, m]) — the explicit form of the JAX package's vmap over
hyperparameter samples.
"""

from __future__ import annotations

import math

import torch

# Above this input dimensionality the pairwise distances use the matmul
# expansion ‖a‖²+‖b‖²−2a·bᵀ; below it the exact per-dimension difference.
_MATMUL_MIN_DIM = 32


def ard_sqdist(x1: torch.Tensor, x2: torch.Tensor,
               ls: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances of length-scaled points.

    x1: (n, D), x2: (m, D), ls: (..., D) → (..., n, m) of
    Σ_d ((x1[i,d]−x2[j,d])/ls[d])², summed left to right over d for D < 32
    (the JAX package's order) and by the matmul form at D ≥ 32.
    """
    lsb = ls.unsqueeze(-2)
    a = x1 / lsb
    b = x2 / lsb
    if x1.shape[-1] >= _MATMUL_MIN_DIM:
        a2 = (a * a).sum(-1)
        b2 = (b * b).sum(-1)
        d2 = a2[..., :, None] + b2[..., None, :] - 2.0 * (a @ b.mT)
    else:
        d2 = None
        for d in range(x1.shape[-1]):
            diff = a[..., :, None, d] - b[..., None, :, d]
            d2 = diff * diff if d2 is None else d2 + diff * diff
    return torch.clamp_min(d2, 0.0)


def _safe_sqrt(r2: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero (not NaN) gradient at r2 == 0 (double-where)."""
    positive = r2 > 0.0
    inner = torch.where(positive, r2, torch.ones_like(r2))
    return torch.where(positive, torch.sqrt(inner), torch.zeros_like(r2))


def matern52(x1, x2, ls):
    """Matérn-5/2: (1 + √5 r + 5/3 r²) exp(−√5 r)."""
    r2 = ard_sqdist(x1, x2, ls)
    r = _safe_sqrt(r2)
    sqrt5 = math.sqrt(5.0)
    return (1.0 + sqrt5 * r + (5.0 / 3.0) * r2) * torch.exp(-sqrt5 * r)


def matern32(x1, x2, ls):
    """Matérn-3/2: (1 + √3 r) exp(−√3 r)."""
    r = _safe_sqrt(ard_sqdist(x1, x2, ls))
    sqrt3 = math.sqrt(3.0)
    return (1.0 + sqrt3 * r) * torch.exp(-sqrt3 * r)


def squared_exp(x1, x2, ls):
    """Squared-exponential (RBF): exp(−r²/2)."""
    return torch.exp(-0.5 * ard_sqdist(x1, x2, ls))


KERNELS = {
    "Matern52": matern52,
    "Matern32": matern32,
    "SquaredExp": squared_exp,
    "ARDSE": squared_exp,
    "SE": squared_exp,
}


def get_kernel(name: str):
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r}; available: {sorted(KERNELS)}"
        ) from None
