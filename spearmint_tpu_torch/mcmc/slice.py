"""Batched stepping-out/shrinking slice sampler (Neal 2003).

JAX counterpart: ``spearmint_tpu/mcmc/slice.py``.  Same algorithm and
defaults as the reference (sigma=1, step_out, max_steps_out=1000,
component-wise mode in a random dimension order, joint mode along a random
unit direction), the same single-call-site phase machine, the same
``MAX_SHRINK`` stay-put fallback, NaN treated as −inf, and the same
``finite_slice`` guard.

The JAX sampler runs one chain and vmaps it; here all K chains advance in
lockstep as a leading batch axis.  Each loop step makes ONE batched
``logprob`` call for the whole chain batch; chains that have finished keep
their state under a mask (as lanes of the vmapped ``while_loop`` do) and
the loop ends when every chain is DONE — one host read per step.
Randomness comes from a ``torch.Generator``: the draws differ from
``jax.random``'s, so the sampler is held to the JAX one in distribution.
"""

from __future__ import annotations

from typing import Callable

import torch

MAX_STEPS_OUT = 1000
MAX_SHRINK = 64

_PH_LO, _PH_UP, _PH_SHRINK, _PH_DONE = 0, 1, 2, 3


def _uniform(gen, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(like.shape[0], generator=gen, dtype=like.dtype,
                      device=like.device)


def _nan_to_ninf(lp: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(lp), float("-inf"), lp)


def _direction_slice(gen, x0, direction, logprob, sigma, step_out,
                     max_steps_out, max_shrink, lp0=None):
    """One slice move of every chain of x0 [K, dim] along direction [K, dim].

    Returns (x_new [K, dim], logprob(x_new) [K]).  ``lp0`` ([K], the
    density at x0) skips the initial evaluation when the caller knows it.
    """

    def dir_lp(z):
        return _nan_to_ninf(logprob(x0 + z[:, None] * direction))

    upper = sigma * _uniform(gen, x0)
    lower = upper - sigma
    if lp0 is None:
        lp0 = dir_lp(torch.zeros_like(upper))
    llh_s = torch.log(_uniform(gen, x0)) + lp0

    # A chain whose current point has −inf density skips the expansion
    # (every finite bracket end would beat llh_s) and accepts the first
    # finite proposal of the shrink phase.
    finite_slice = torch.isfinite(llh_s)
    phase = torch.full_like(upper, _PH_SHRINK, dtype=torch.int32)
    if step_out:
        phase = torch.where(finite_slice, _PH_LO, phase).to(torch.int32)
    z = torch.zeros_like(upper)
    llh = lp0.clone()
    i_lo = torch.zeros_like(phase)
    i_up = torch.zeros_like(phase)
    i_sh = torch.zeros_like(phase)

    while bool((phase < _PH_DONE).any()):
        z_prop = lower + (upper - lower) * _uniform(gen, x0)
        in_lo = phase == _PH_LO
        in_up = phase == _PH_UP
        in_sh = phase == _PH_SHRINK
        pt = torch.where(in_lo, lower, torch.where(in_up, upper, z_prop))
        lp = dir_lp(pt)  # the single batched call site of the move
        above = lp > llh_s

        expand_lo = in_lo & above & (i_lo < max_steps_out)
        leave_lo = in_lo & ~expand_lo
        expand_up = in_up & above & (i_up < max_steps_out)
        leave_up = in_up & ~expand_up
        accept = in_sh & above
        reject = in_sh & ~above
        exhausted = reject & (i_sh + 1 >= max_shrink)

        lower = torch.where(expand_lo, lower - sigma, lower)
        upper = torch.where(expand_up, upper + sigma, upper)
        # rejected z<0 raises the lower bound, z>=0 lowers the upper one
        lower = torch.where(reject & (z_prop < 0.0), z_prop, lower)
        upper = torch.where(reject & (z_prop >= 0.0), z_prop, upper)
        z = torch.where(accept, z_prop, z)
        llh = torch.where(accept, lp, llh)

        phase = torch.where(leave_lo, _PH_UP, phase)
        phase = torch.where(leave_up, _PH_SHRINK, phase)
        phase = torch.where(accept | exhausted, _PH_DONE, phase)
        phase = phase.to(torch.int32)
        i_lo = i_lo + expand_lo.to(torch.int32)
        i_up = i_up + expand_up.to(torch.int32)
        i_sh = i_sh + in_sh.to(torch.int32)

    # shrink budget exhausted: z stays 0, i.e. the chain stays at x0 with
    # density lp0 (the reference raises instead)
    return x0 + z[:, None] * direction, llh


def slice_sample(gen: torch.Generator, x0: torch.Tensor,
                 logprob: Callable[[torch.Tensor], torch.Tensor],
                 sigma: float = 1.0, step_out: bool = True,
                 max_steps_out: int = MAX_STEPS_OUT,
                 max_shrink: int = MAX_SHRINK, compwise: bool = False,
                 lp0: torch.Tensor | None = None):
    """One slice-sampling sweep of every chain of x0 [K, dim].

    ``logprob`` maps [K, dim] → [K].  compwise=True: one move per
    coordinate in a per-chain random order; compwise=False: one move along
    a per-chain random unit direction.  ``lp0`` ([K]) is the caller's known
    ``logprob(x0)``.  Returns (x [K, dim], logprob(x) [K]).
    """
    k_chains, dim = x0.shape
    kw = dict(sigma=sigma, step_out=step_out, max_steps_out=max_steps_out,
              max_shrink=max_shrink)
    if compwise:
        order = torch.argsort(
            torch.rand(k_chains, dim, generator=gen, device=x0.device),
            dim=1)
        lp = _nan_to_ninf(logprob(x0) if lp0 is None else lp0)
        x = x0
        for t in range(dim):
            direction = torch.nn.functional.one_hot(
                order[:, t], dim).to(x0.dtype)
            x, lp = _direction_slice(gen, x, direction, logprob, lp0=lp,
                                     **kw)
        return x, lp
    direction = torch.randn(k_chains, dim, generator=gen, dtype=x0.dtype,
                            device=x0.device)
    direction = direction / torch.sqrt((direction ** 2).sum(-1, keepdim=True))
    if lp0 is not None:
        lp0 = _nan_to_ninf(lp0)
    return _direction_slice(gen, x0, direction, logprob, lp0=lp0, **kw)
