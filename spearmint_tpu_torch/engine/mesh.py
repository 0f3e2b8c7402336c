"""The chains × candidates rank grid of the suggestion step.

JAX counterpart: ``spearmint_tpu/engine/mesh.py``, a 2-D device mesh
under GSPMD:

  * axis ``chains``: independent MCMC chains, their samples and caches
    (data parallel);
  * axis ``cand``: the EI candidate batch; the argmax needs every shard.

Here the ranks of the default process group are laid out on the grid and
each rank runs ``engine.suggest.suggest_step`` on its chains and
candidates.  GSPMD does not change the math, and neither may this:

  * every random tensor (the sampler's and the fantasies') is drawn at the
    global chain and sample shape, and each rank keeps its rows
    (``mcmc/slice.ChainShard``);
  * the sampler's loop ends when the chains of every rank are done (an
    all-reduce over ``chains`` each step), so the generators stay in step
    and the ranks make the same collective calls;
  * the EI sums over samples and ``n_ok`` are all-reduced over ``chains``,
    then the candidate shards are gathered over ``cand``;
  * L-BFGS sums the averaged EI's value over ``chains`` and its gradient
    likewise (``Mesh.sum_chains_grad``: the gradient of a sum of the
    ranks' terms at a replicated point is the sum of their gradients).

Every rank returns the whole result (all chains, all candidates), the same
on every rank.  Observations and pending points are replicated: they are
O(n·D), small beside the per-chain factorizations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from spearmint_tpu_torch.engine import distributed
from spearmint_tpu_torch.engine.suggest import _step
from spearmint_tpu_torch.mcmc.slice import ChainShard
from spearmint_tpu_torch.utils.platform import resolve_device

CHAINS_AXIS = "chains"
CAND_AXIS = "cand"


class Mesh(NamedTuple):
    """This rank's place on a (chains, cand) grid of the default group's
    ranks (rank = chains index · cand shards + cand index), and its two
    subgroups: the ranks that share its candidates (``chains_group``, one
    per chains shard) and those that share its chains (``cand_group``);
    None where the axis has one shard."""

    shape: tuple             # (chains shards, cand shards)
    index: tuple             # my (chains, cand) coordinates
    chains_group: object
    cand_group: object
    device: torch.device

    def rows(self, axis: str, total: int) -> tuple:
        """My [lo, hi) of ``total`` rows split evenly over ``axis``."""
        a = (CHAINS_AXIS, CAND_AXIS).index(axis)
        parts = self.shape[a]
        if total % parts:
            raise ValueError(f"{total} rows do not split over {parts} "
                             f"{axis} shards")
        width = total // parts
        return self.index[a] * width, (self.index[a] + 1) * width

    def chain_shard(self, chains: int) -> ChainShard | None:
        if self.chains_group is None:
            return None
        return ChainShard(*self.rows(CHAINS_AXIS, chains), chains,
                          self.chains_group)

    def sum_chains(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the chains shards (no gradient)."""
        if self.chains_group is not None:
            t = t.contiguous()
            dist.all_reduce(t, group=self.chains_group)
        return t

    def sum_chains_grad(self, fun):
        """``fun`` (points → this rank's term [M]) summed over the chains
        shards, value and gradient, for L-BFGS."""
        if self.chains_group is None:
            return fun
        group = self.chains_group
        return lambda pts: _SumOut.apply(fun(_SumGradIn.apply(pts, group)),
                                         group)

    def gather(self, axis: str, t: torch.Tensor, total: int) -> torch.Tensor:
        """The [total, ...] whole of ``t``, my rows of ``axis``, on every
        rank.  An all-reduce of the rows embedded in zeros: x + 0 is x
        exactly, and it needs no all-gather, which not every backend takes
        for CUDA tensors."""
        group = self.chains_group if axis == CHAINS_AXIS else self.cand_group
        if group is None:
            return t
        lo, hi = self.rows(axis, total)
        out = torch.zeros((total,) + t.shape[1:], dtype=t.dtype,
                          device=t.device)
        out[lo:hi] = t
        dist.all_reduce(out, group=group)
        return out


class _SumOut(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the identity (each
    rank's term takes the output's gradient as it is)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumGradIn(torch.autograd.Function):
    """Forward: the identity on a replicated input.  Backward: the sum of
    the ranks' gradients, the gradient of the summed output."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def make_mesh(chains_shards: int | None = None,
              cand_shards: int | None = None, device="cuda") -> Mesh:
    """Lay the default group's ranks out on a (chains, cand) grid.

    Defaults: every rank on the chains axis (chain parallelism is the
    axis of most arithmetic per byte: each shard runs whole Choleskys).
    Every rank must call this with the same arguments: it creates the
    subgroups, in the same order everywhere."""
    dev = resolve_device(device)
    n = distributed.world_size()
    if chains_shards is None and cand_shards is None:
        chains_shards, cand_shards = n, 1
    elif chains_shards is None:
        chains_shards = n // cand_shards
    elif cand_shards is None:
        cand_shards = n // chains_shards
    if chains_shards * cand_shards != n:
        raise ValueError(f"mesh {chains_shards}x{cand_shards} != {n} ranks")
    rank = dist.get_rank() if dist.is_initialized() else 0
    i, j = divmod(rank, cand_shards)
    chains_group = cand_group = None
    if chains_shards > 1:
        for c in range(cand_shards):
            g = dist.new_group([r * cand_shards + c
                                for r in range(chains_shards)])
            if c == j:
                chains_group = g
    if cand_shards > 1:
        for r in range(chains_shards):
            g = dist.new_group([r * cand_shards + c
                                for c in range(cand_shards)])
            if r == i:
                cand_group = g
    return Mesh((chains_shards, cand_shards), (i, j), chains_group,
                cand_group, dev)


def suggest_shardings(mesh: Mesh) -> tuple:
    """The axis that splits the leading axis of each positional input of
    ``suggest_step`` (gen, hypers, x, y, mask, pend, pend_mask, cand,
    cand_mask), or None where it is replicated: chain states over
    ``chains``, the candidates over ``cand`` (the same on every mesh)."""
    return (None, CHAINS_AXIS, None, None, None, None, None, CAND_AXIS,
            CAND_AXIS)


def sharded_suggest(mesh: Mesh, config):
    """``suggest_step`` over the mesh: a callable (gen, hypers, x, y, mask,
    pend, pend_mask, cand, cand_mask[, stage_times]) → SuggestResult, the
    whole result on every rank.  Every rank passes the same inputs and a
    generator in the same state.  Each rank runs its chains as one batch:
    ``config.chain_chunk`` must be 0."""
    if config.chain_chunk:
        raise ValueError("the chains mesh splits the chains itself: "
                         "chain_chunk must be 0")

    def step(gen, hypers, x, y, mask, pend, pend_mask, cand, cand_mask,
             stage_times: dict | None = None):
        return _step(gen, hypers, x, y, mask, pend, pend_mask, cand,
                     cand_mask, config, mesh.device, stage_times, mesh)

    return step
