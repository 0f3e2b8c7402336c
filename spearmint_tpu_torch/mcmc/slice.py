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

With a ``ChainShard`` the chain batch is one rank's rows of a batch split
over a process group (``engine/mesh``): every draw is made at the global
shape and the rank keeps its rows, and the loop ends when the chains of
every rank are DONE (one all-reduce per step), so each rank's chains take
exactly the steps and draws they take unsharded, and the ranks make the
same collective calls.  Without one, nothing changes.

``with_counts`` returns each move's loop counters as the JAX sampler's
does: int32 (lower step-outs, upper step-outs, shrink evaluations) per
chain, left on the device.  ``move_evals`` turns them into the move's
``logprob`` evaluations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

MAX_STEPS_OUT = 1000
MAX_SHRINK = 64

_PH_LO, _PH_UP, _PH_SHRINK, _PH_DONE = 0, 1, 2, 3


class ChainShard(NamedTuple):
    """Rows [lo, hi) of a batch of ``total`` chains that ``group`` splits."""

    lo: int
    hi: int
    total: int
    group: object = None


def draw_rows(fn, gen, shape, like, shard: ChainShard | None):
    """``fn`` (torch.rand / randn) over ``shape``, whose leading axis is the
    chain batch: at the global batch, and this rank's rows, when sharded."""
    if shard is None:
        return fn(shape, generator=gen, dtype=like.dtype, device=like.device)
    out = fn((shard.total,) + tuple(shape[1:]), generator=gen,
             dtype=like.dtype, device=like.device)
    return out[shard.lo:shard.hi]


def _uniform(gen, like: torch.Tensor, shard=None) -> torch.Tensor:
    return draw_rows(torch.rand, gen, (like.shape[0],), like, shard)


def _any_running(phase: torch.Tensor, shard: ChainShard | None) -> bool:
    """Whether a chain of the batch (of every rank, when sharded) is not
    DONE."""
    running = (phase < _PH_DONE).any().to(torch.int32)
    if shard is not None:
        dist.all_reduce(running, op=dist.ReduceOp.MAX, group=shard.group)
    return bool(running)


def _nan_to_ninf(lp: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(lp), float("-inf"), lp)


def _direction_slice(gen, x0, direction, logprob, sigma, step_out,
                     max_steps_out, max_shrink, lp0=None, shard=None):
    """One slice move of every chain of x0 [K, dim] along direction [K, dim].

    Returns (x_new [K, dim], logprob(x_new) [K], counts [K, 3]): counts
    are the loop counters i_lo, i_up and i_sh at exit.  ``lp0`` ([K], the
    density at x0) skips the initial evaluation when the caller knows it.
    """

    def dir_lp(z):
        return _nan_to_ninf(logprob(x0 + z[:, None] * direction))

    upper = sigma * _uniform(gen, x0, shard)
    lower = upper - sigma
    if lp0 is None:
        lp0 = dir_lp(torch.zeros_like(upper))
    llh_s = torch.log(_uniform(gen, x0, shard)) + lp0

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

    while _any_running(phase, shard):
        z_prop = lower + (upper - lower) * _uniform(gen, x0, shard)
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
    return (x0 + z[:, None] * direction, llh,
            torch.stack((i_lo, i_up, i_sh), dim=-1))


def move_evals(counts: torch.Tensor, stepped_out) -> torch.Tensor:
    """The ``logprob`` evaluations of each move, from its counters
    ([..., 3]): lo + up + sh + 2 for a chain that stepped out (the two
    evaluations that left the bracket), sh for one that did not.  A chain
    steps out when ``step_out`` is on and its slice is finite, i.e. its
    density at the start of the move is finite.  The batched loop makes
    max over chains of these calls per move; the seed evaluation of a
    sweep called without ``lp0`` is one more."""
    evals = counts.sum(-1)
    return torch.where(torch.as_tensor(stepped_out, device=counts.device),
                       evals + 2, evals)


def slice_sample(gen: torch.Generator, x0: torch.Tensor,
                 logprob: Callable[[torch.Tensor], torch.Tensor],
                 sigma: float = 1.0, step_out: bool = True,
                 max_steps_out: int = MAX_STEPS_OUT,
                 max_shrink: int = MAX_SHRINK, compwise: bool = False,
                 lp0: torch.Tensor | None = None,
                 shard: ChainShard | None = None,
                 with_counts: bool = False):
    """One slice-sampling sweep of every chain of x0 [K, dim].

    ``logprob`` maps [K, dim] → [K].  compwise=True: one move per
    coordinate in a per-chain random order; compwise=False: one move along
    a per-chain random unit direction.  ``lp0`` ([K]) is the caller's known
    ``logprob(x0)``.  ``shard``: x0 is this rank's rows of a split batch.
    Returns (x [K, dim], logprob(x) [K]), and with ``with_counts`` also the
    moves' int32 loop counters (lower step-outs, upper step-outs, shrink
    evaluations): [K, 3] for the joint move, [K, dim, 3] compwise, in the
    JAX sampler's layout, where row t is the t-th move made, i.e. the move
    of coordinate order[t] of that chain, not of coordinate t.  The
    counters stay on the device and change neither the draws nor the
    result.
    """
    k_chains, dim = x0.shape
    kw = dict(sigma=sigma, step_out=step_out, max_steps_out=max_steps_out,
              max_shrink=max_shrink, shard=shard)
    if compwise:
        order = torch.argsort(
            draw_rows(torch.rand, gen, (k_chains, dim),
                  torch.empty((), device=x0.device), shard), dim=1)
        lp = _nan_to_ninf(logprob(x0) if lp0 is None else lp0)
        x, counts = x0, []
        for t in range(dim):
            direction = torch.nn.functional.one_hot(
                order[:, t], dim).to(x0.dtype)
            x, lp, c = _direction_slice(gen, x, direction, logprob, lp0=lp,
                                        **kw)
            counts.append(c)
        return (x, lp, torch.stack(counts, dim=1)) if with_counts else (x, lp)
    direction = draw_rows(torch.randn, gen, (k_chains, dim), x0, shard)
    direction = direction / torch.sqrt((direction ** 2).sum(-1, keepdim=True))
    if lp0 is not None:
        lp0 = _nan_to_ninf(lp0)
    x, lp, counts = _direction_slice(gen, x0, direction, logprob, lp0=lp0,
                                     **kw)
    return (x, lp, counts) if with_counts else (x, lp)
