"""Hyperparameter priors, exactly as the reference choosers roll them in.

JAX counterpart: ``spearmint_tpu/core/priors.py`` (verbatim in torch):

  * noise   — horseshoe: lp += log(log(1 + (noise_scale/noise)²)),
              noise_scale = 0.1
  * amp2    — lognormal: lp −= ½·(log(√amp2)/amp2_scale)², amp2_scale = 1
  * ls      — tophat on (0, max_ls], max_ls = 2
  * mean    — flat, constrained to [min(y), max(y)]
"""

from __future__ import annotations

import torch

NOISE_SCALE = 0.1   # horseshoe scale on the noise variance
AMP2_SCALE = 1.0    # lognormal scale on the amplitude
MAX_LS = 2.0        # tophat upper bound on ARD length scales
DEFAULT_NOISE = 1e-3  # fixed noise in noiseless mode / initial value


def horseshoe_logpdf(noise: torch.Tensor,
                     scale: float = NOISE_SCALE) -> torch.Tensor:
    """Unnormalized horseshoe density used by the reference for noise."""
    return torch.log(torch.log(1.0 + (scale / noise) ** 2))


def lognormal_amp2_term(amp2: torch.Tensor,
                        scale: float = AMP2_SCALE) -> torch.Tensor:
    """−½ (log √amp2 / scale)², added to the log posterior."""
    return -0.5 * (torch.log(torch.sqrt(amp2)) / scale) ** 2


def ls_in_bounds(ls: torch.Tensor, max_ls: float = MAX_LS) -> torch.Tensor:
    """Tophat support indicator over the last (dimension) axis."""
    return ((ls > 0.0) & (ls <= max_ls)).all(-1)


def mean_in_bounds(mean, y_min, y_max) -> torch.Tensor:
    """Reference clamps the constant mean inside the observed value range."""
    return (mean >= y_min) & (mean <= y_max)
