"""GP hyperparameter MCMC over a batch of chains.

JAX counterpart: ``spearmint_tpu/mcmc/chains.py``.  The reference order of
operations, kept exactly:

  1. jointly slice-sample (mean, amp2[, noise]) along a random direction,
     with flat-in-bounds mean, lognormal amp2, horseshoe noise priors;
  2. component-wise slice-sample the ARD length scales under a tophat
     (0, max_ls] prior.

Chains are a leading batch axis of ``GPHypers``; the GP log-marginal is
carried across the joint → ls → next-sweep sequence (``sample_hypers_lp``)
so each move skips its initial evaluation.  In band mode (``band_joint``)
the joint move evaluates through one band reduction per move
(``ops/band``) and each move seeds its own lp0, so no carry is used.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from spearmint_tpu_torch.core import linalg, priors
from spearmint_tpu_torch.core.kernels import matern52
from spearmint_tpu_torch.core.likelihood import GPHypers, log_marginal
from spearmint_tpu_torch.mcmc.slice import ChainShard, slice_sample
from spearmint_tpu_torch.ops.band import band_marginal_factory


class MCMCConfig(NamedTuple):
    """Static sampler configuration."""

    noiseless: bool = False
    max_ls: float = priors.MAX_LS
    noise_scale: float = priors.NOISE_SCALE
    amp2_scale: float = priors.AMP2_SCALE
    kernel: Callable = matern52
    marginal: Callable = log_marginal
    # Band mode: the joint move reduces M to block-tridiagonal once per
    # move and evaluates in O(n·b²) (ops/band); needs a contiguous mask
    # and n % band_block == 0 (every pad bucket ≥ 512 is).
    band_joint: bool = False
    band_block: int = 128
    # The chain batch is this rank's rows of a batch split over a process
    # group (engine/mesh): draws at the global shape, a global loop exit.
    chain_shard: ChainShard | None = None


def init_hypers(y: torch.Tensor, mask: torch.Tensor, ndim: int) -> GPHypers:
    """Reference ``_real_init`` state of ONE chain (unbatched fields):
    ls=1, mean=mean(y), amp2=std(y)+1e-4, noise=1e-3."""
    return GPHypers(
        mean=linalg.masked_mean(y, mask),
        amp2=linalg.masked_std(y, mask) + 1e-4,
        noise=torch.full((), priors.DEFAULT_NOISE, dtype=y.dtype,
                         device=y.device),
        ls=torch.ones(ndim, dtype=y.dtype, device=y.device),
    )


def _joint_logprob(vec, x, y, mask, ls, config: MCMCConfig,
                   marginal3: Callable | None = None):
    """Log posterior of (mean, amp2[, noise]) [K, 2|3] at fixed ls [K, D].

    ``marginal3`` (mean, amp2, noise) → lp [K] replaces ``config.marginal``
    (band mode passes the per-move banded closure)."""
    mean, amp2 = vec[:, 0], vec[:, 1]
    noise = (torch.full_like(mean, priors.DEFAULT_NOISE) if config.noiseless
             else vec[:, 2])
    valid = (priors.mean_in_bounds(mean, linalg.masked_min(y, mask),
                                   linalg.masked_max(y, mask))
             & (amp2 > 0.0) & (noise > 0.0))
    amp2_s = torch.where(amp2 > 0.0, amp2, 1.0)
    noise_s = torch.where(noise > 0.0, noise, 1.0)
    if marginal3 is None:
        lp = config.marginal(x, y, mask, GPHypers(mean, amp2_s, noise_s, ls),
                             config.kernel)
    else:
        lp = marginal3(mean, amp2_s, noise_s)
    lp = lp + _joint_prior_terms(amp2_s, noise_s, config)
    return torch.where(valid, lp, float("-inf"))


def _ls_logprob(ls, x, y, mask, hypers: GPHypers, config: MCMCConfig):
    """Log posterior of ARD length scales [K, D] under the tophat prior."""
    valid = priors.ls_in_bounds(ls, config.max_ls)
    ls_s = torch.clamp(ls, 1e-6, config.max_ls)
    lp = config.marginal(
        x, y, mask, GPHypers(hypers.mean, hypers.amp2, hypers.noise, ls_s),
        config.kernel)
    return torch.where(valid, lp, float("-inf"))


def _joint_prior_terms(amp2, noise, config: MCMCConfig):
    """The prior terms separating the joint-move log posterior from the
    bare GP log-marginal at an in-bounds state."""
    t = priors.lognormal_amp2_term(amp2, config.amp2_scale)
    if not config.noiseless:
        t = t + priors.horseshoe_logpdf(noise, config.noise_scale)
    return t


def sample_hypers_lp(gen: torch.Generator, hypers: GPHypers,
                     lp_mar: torch.Tensor, x, y, mask,
                     config: MCMCConfig = MCMCConfig(),
                     with_counts: bool = False):
    """One full sweep of every chain, carrying the GP log-marginal.

    ``lp_mar`` [K] is ``config.marginal`` at ``hypers``.  The joint move's
    log posterior at the current state is lp_mar + prior terms; the ls
    move's at the post-joint state is the joint move's accepted lp minus
    the same terms.  In band mode ``lp_mar`` is unused (None will do): the
    joint move seeds with one banded evaluation and the ls move with one
    dense one, so each compares lp values of its own path.  Returns
    (hypers', lp_mar'), and with ``with_counts`` also the moves' loop
    counters (``slice_sample``'s): (joint [K, 3], ls [K, D, 3])."""
    if config.noiseless:
        vec0 = torch.stack([hypers.mean, hypers.amp2], dim=1)
    else:
        vec0 = torch.stack([hypers.mean, hypers.amp2, hypers.noise], dim=1)

    if config.band_joint:
        marginal3 = band_marginal_factory(x, y, mask, hypers.ls,
                                          config.kernel, config.band_block)
        lp0_joint = None
    else:
        marginal3 = None
        lp0_joint = lp_mar + _joint_prior_terms(hypers.amp2, hypers.noise,
                                                config)

    def joint_lp(vec):
        return _joint_logprob(vec, x, y, mask, hypers.ls, config, marginal3)

    vec, lp_joint, *c_joint = slice_sample(
        gen, vec0, joint_lp, compwise=False, lp0=lp0_joint,
        shard=config.chain_shard, with_counts=with_counts)
    mean, amp2 = vec[:, 0], vec[:, 1]
    noise = (torch.full_like(mean, priors.DEFAULT_NOISE) if config.noiseless
             else vec[:, 2])
    mid = GPHypers(mean, amp2, noise, hypers.ls)

    def ls_lp(ls):
        return _ls_logprob(ls, x, y, mask, mid, config)

    lp0_ls = (None if config.band_joint
              else lp_joint - _joint_prior_terms(amp2, noise, config))
    ls, lp_ls, *c_ls = slice_sample(gen, hypers.ls, ls_lp, compwise=True,
                                    lp0=lp0_ls, shard=config.chain_shard,
                                    with_counts=with_counts)
    out = GPHypers(mean, amp2, noise, ls), lp_ls
    return out + ((*c_joint, *c_ls),) if with_counts else out


def marginal_at(x, y, mask, hypers: GPHypers, config: MCMCConfig):
    """One explicit carry-seed evaluation of ``config.marginal``."""
    return config.marginal(x, y, mask, hypers, config.kernel)


def seed_lp(x, y, mask, hypers: GPHypers, config: MCMCConfig):
    """The carry that starts a run of sweeps: ``marginal_at``, or None in
    band mode, where no move reads it (the JAX package's compiler drops
    that evaluation; eager PyTorch would pay one B1 call for it)."""
    if config.band_joint:
        return None
    return marginal_at(x, y, mask, hypers, config)


def sample_hypers(gen, hypers: GPHypers, x, y, mask,
                  config: MCMCConfig = MCMCConfig()) -> GPHypers:
    """One full sweep of every chain, re-evaluating the marginal first."""
    lp_mar = seed_lp(x, y, mask, hypers, config)
    out, _ = sample_hypers_lp(gen, hypers, lp_mar, x, y, mask, config)
    return out


def burnin(gen, hypers: GPHypers, x, y, mask, steps: int,
           config: MCMCConfig = MCMCConfig()) -> GPHypers:
    """Reference burn-in: ``steps`` carried sweeps of every chain."""
    lp = seed_lp(x, y, mask, hypers, config)
    for _ in range(steps):
        hypers, lp = sample_hypers_lp(gen, hypers, lp, x, y, mask, config)
    return hypers
