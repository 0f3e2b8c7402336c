"""Elliptical slice sampling (Murray, Adams & MacKay 2010), batched.

JAX counterpart: ``spearmint_tpu/mcmc/ess.py``.  Used by the constrained
chooser to sample the latent constraint values under a GP prior with a
probit likelihood.

One move: draw an ellipse through the current state and a prior sample,
then shrink the angle bracket until the log-likelihood beats a uniform
slice threshold.  The JAX move runs one chain and is vmapped; here all K
chains advance in lockstep on a leading batch axis, as in ``mcmc/slice``:
one batched ``log_lik`` call per loop step, chains that have accepted keep
their angle under a mask, and the loop ends when every chain has accepted
or ``MAX_SHRINK`` steps have run (a chain still rejecting then stays put).
One host read per step.  Randomness comes from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

MAX_SHRINK = 64


def elliptical_slice(
    gen: torch.Generator,
    f: torch.Tensor,                 # [K, N] current latent values
    prior_chol: torch.Tensor,        # [K, N, N] chol of each GP prior cov
    log_lik: Callable[[torch.Tensor], torch.Tensor],   # [K, N] → [K]
) -> torch.Tensor:
    """One ESS move of every chain's latent vector; returns [K, N]."""
    k_chains = f.shape[0]

    def uniform():
        return torch.rand(k_chains, generator=gen, dtype=f.dtype,
                          device=f.device)

    normal = torch.randn(f.shape + (1,), generator=gen, dtype=f.dtype,
                         device=f.device)
    nu = (prior_chol @ normal)[..., 0]
    log_y = log_lik(f) + torch.log(uniform())
    theta = 2.0 * math.pi * uniform()
    lo, hi = theta - 2.0 * math.pi, theta

    def proposal(th):
        return f * torch.cos(th)[:, None] + nu * torch.sin(th)[:, None]

    th = theta
    ok = torch.zeros(k_chains, dtype=torch.bool, device=f.device)
    for _ in range(MAX_SHRINK):
        ok = ok | (log_lik(proposal(th)) > log_y)
        if bool(ok.all()):
            break
        # a rejected angle below 0 raises the lower end, else lowers the
        # upper one; accepted chains keep their angle
        lo = torch.where(~ok & (th < 0.0), th, lo)
        hi = torch.where(~ok & (th >= 0.0), th, hi)
        th = torch.where(ok, th, lo + (hi - lo) * uniform())
    return torch.where(ok[:, None], proposal(th), f)
