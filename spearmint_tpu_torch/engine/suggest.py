"""The suggestion step: MCMC → posterior caches → EI → L-BFGS.

JAX counterpart: ``spearmint_tpu/engine/suggest.py`` (``suggest_step``).

  chains × mcmc_iters batched slice-sampling sweeps (kernel B1 per
  evaluation; in band mode the joint move's evaluations are B5, after one
  band reduction per move) → one cache per sample (B2, and B3 for L⁻¹)
  → fantasized pending outcomes and augmented caches when jobs are
  pending → EI[S, C] over the candidates, NaN-robust average over samples
  → top-k starts → batched projected L-BFGS on the sample-averaged EI.

The chains axis is a leading batch axis; ``chain_chunk`` runs it in
sequential groups to bound the [group, N, N] buffers.  Shapes are padded
with masks exactly as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from spearmint_tpu_torch.acquire import ei as ei_mod
from spearmint_tpu_torch.acquire.fantasy import fantasize_batch
from spearmint_tpu_torch.acquire.optimize import minimize_lbfgs_b
from spearmint_tpu_torch.core.kernels import get_kernel
from spearmint_tpu_torch.core.likelihood import GPHypers
from spearmint_tpu_torch.mcmc.chains import (
    MCMCConfig, init_hypers, sample_hypers_lp, seed_lp,
)
from spearmint_tpu_torch.mcmc.slice import ChainShard, draw_rows
from spearmint_tpu_torch.utils import trace
from spearmint_tpu_torch.utils.platform import resolve_device


class SuggestConfig(NamedTuple):
    """Static configuration; defaults mirror the reference chooser args."""

    mcmc_iters: int = 10
    noiseless: bool = False
    kernel_name: str = "Matern52"
    max_ls: float = 2.0
    grid_subset: int = 20
    lbfgs_iters: int = 50
    optimize: bool = True          # False → grid-only EI (GPEIChooser)
    has_pending: bool = False
    n_fantasies: int = 10          # fantasy draws per hyper sample
    chain_chunk: int = 0           # >0: chain/sample axis in groups
    explicit_inverse: bool = True  # materialize L⁻¹ per sample (B3)
    band_joint: bool = False       # joint move via per-move band
                                   # reduction (ops/band); the chooser
                                   # gates it on band_joint_min

    @property
    def kernel(self):
        return get_kernel(self.kernel_name)

    @property
    def mcmc(self) -> MCMCConfig:
        return MCMCConfig(noiseless=self.noiseless, max_ls=self.max_ls,
                          kernel=self.kernel, band_joint=self.band_joint)


class SuggestResult(NamedTuple):
    hypers: GPHypers           # [chains] updated chain states
    samples: GPHypers          # [S] this call's samples, chains-major
    ei: torch.Tensor           # [C] sample-averaged EI
    best_cand: torch.Tensor    # argmax index into the candidates
    best_cand_ei: torch.Tensor
    x_opt: torch.Tensor        # (D,) best off-grid point
    ei_opt: torch.Tensor       # its EI
    n_ok: torch.Tensor = None  # samples whose cache was finite; 0 → the
                               # EI average is all zeros and carries no
                               # signal (callers fall back to grid order)
    lbfgs_useful: torch.Tensor = None  # L-BFGS's useful_iters; None
                                       # where no refinement ran


def nan_robust_mean(samples: torch.Tensor, ok: torch.Tensor, reduce=None):
    """Mean over axis 0 of the usable (``ok``, finite) samples, and n_ok.

    ``reduce`` (a sum over ranks, ``engine/mesh``) takes the local sums and
    count when the samples are split over ranks."""
    n_ok_true = ok.to(torch.int32).sum()
    ok_b = ok.reshape(ok.shape + (1,) * (samples.ndim - 1))
    samples = torch.where(ok_b & torch.isfinite(samples), samples, 0.0)
    total = samples.sum(0)
    if reduce is not None:
        packed = reduce(torch.cat([total.reshape(-1),
                                   n_ok_true.to(total.dtype)[None]]))
        total = packed[:-1].reshape(total.shape)
        n_ok_true = packed[-1].to(torch.int32)
    n_ok = torch.clamp_min(n_ok_true.to(samples.dtype), 1.0)
    return total / n_ok, n_ok_true


def _groups(lead: int, chunk: int):
    """Slices of the leading axis: one group unless ``chunk`` divides it."""
    if chunk <= 0 or lead % chunk:
        return [slice(0, lead)]
    return [slice(i, i + chunk) for i in range(0, lead, chunk)]


def _take(h, sl):
    """Rows ``sl`` of every field of a state tuple (GPHypers and the like)."""
    return type(h)(*(a[sl] for a in h))


def _cat(parts):
    return type(parts[0])(*(torch.cat(a, 0) for a in zip(*parts)))


def _stack_iters(its):
    """[iters] states of a [group] batch → one [group·iters] state,
    chains-major (the JAX package's ``_flatten_samples``)."""
    return type(its[0])(*(torch.stack(a, 1).reshape((-1,) + a[0].shape[1:])
                          for a in zip(*its)))


def _cat_caches(parts):
    if len(parts) == 1:
        return parts[0]
    fields = {}
    for name in ei_mod.PosteriorCache._fields:
        vals = [getattr(p, name) for p in parts]
        fields[name] = (None if vals[0] is None else
                        _cat(vals) if name == "hypers" else torch.cat(vals))
    return ei_mod.PosteriorCache(**fields)


@contextlib.contextmanager
def _stage(clock: trace.StageClock, name):
    """One stage of a step: a profiler range ``stage:<name>`` (what a trace
    shows of the stage, as the JAX package's name stack does), timed by
    ``clock``."""
    with trace.span(f"stage:{name}"), clock.stage(name):
        yield


def _sample_chains(gen, hypers: GPHypers, x, y, mask, config: SuggestConfig,
                   mcmc: MCMCConfig | None = None):
    """``config.mcmc_iters`` carried sweeps of every chain, in groups of
    ``chain_chunk``, under ``mcmc`` (default ``config.mcmc``; the sharded
    steps pass their own marginal or chain shard).  Returns (last states
    [chains], samples [S])."""
    mcmc = mcmc or config.mcmc
    h_parts, s_parts = [], []
    for sl in _groups(hypers.mean.shape[0], config.chain_chunk):
        h = _take(hypers, sl)
        lp = seed_lp(x, y, mask, h, mcmc)
        its = []
        for _ in range(config.mcmc_iters):
            h, lp = sample_hypers_lp(gen, h, lp, x, y, mask, mcmc)
            its.append(h)
        h_parts.append(h)
        s_parts.append(_stack_iters(its))
    return _cat(h_parts), _cat(s_parts)


def _value_caches(x, y, mask, flat: GPHypers, config: SuggestConfig):
    """One posterior cache per sample (no pending jobs), in groups."""
    return _cat_caches([
        ei_mod.make_cache(x, y, mask, _take(flat, sl), config.kernel,
                          with_inverse=config.explicit_inverse)
        for sl in _groups(flat.mean.shape[0], config.chain_chunk)])


def _pending_caches(gen, x, y, mask, pend, pend_mask, flat: GPHypers,
                    config: SuggestConfig, shard: ChainShard | None = None):
    """The value caches of a suggestion: with pending jobs, ``n_fantasies``
    fantasized outcomes per sample over the augmented data (obs ∪ pend)
    sharing one factorization; without, ``_value_caches``.  With ``shard``
    the samples are those of this rank's chains, and the fantasy draws are
    made for every chain's and kept for these.  Returns (cache, x_all,
    mask_all), the data the cache's EI reads."""
    if not config.has_pending:
        return _value_caches(x, y, mask, flat, config), x, mask
    s = flat.mean.shape[0]
    x_all = torch.cat([x, pend], 0)
    mask_all = torch.cat([mask, pend_mask], 0)
    n_fant = config.n_fantasies
    it = config.mcmc_iters
    rows = None if shard is None else ChainShard(
        shard.lo * it, shard.hi * it, shard.total * it)
    draws = draw_rows(torch.randn, gen, (s, n_fant, pend.shape[0]), x, rows)
    caches = []
    for sl in _groups(s, config.chain_chunk):
        hs = _take(flat, sl)
        fants = fantasize_batch(draws[sl], x, y, mask, pend, pend_mask, hs,
                                config.kernel)                  # [g, F, P]
        y_augs = torch.cat([y.expand(fants.shape[0], n_fant, -1), fants], -1)
        caches.append(ei_mod.make_cache_aug(
            x_all, mask_all, y_augs, hs, config.kernel,
            with_inverse=config.explicit_inverse))
    return _cat_caches(caches), x_all, mask_all


def _refine(neg_fun, cand, masked, config: SuggestConfig):
    """Batched projected L-BFGS on the unit box from the ``grid_subset``
    best candidates of ``masked``; returns (best point, its value, the
    run's ``useful_iters``)."""
    starts = cand[torch.topk(masked, min(config.grid_subset,
                                         cand.shape[0])).indices]
    box = torch.zeros(cand.shape[1], dtype=cand.dtype, device=cand.device)
    res = minimize_lbfgs_b(neg_fun, starts, box, box + 1.0,
                           iters=config.lbfgs_iters)
    lane = torch.argmin(res.fun)
    return res.x[lane], -res.fun[lane], res.useful_iters


def suggest_step(gen: torch.Generator, hypers: GPHypers, x, y, mask, pend,
                 pend_mask, cand, cand_mask,
                 config: SuggestConfig = SuggestConfig(),
                 device="cuda", stage_times: dict | None = None
                 ) -> SuggestResult:
    """One suggestion on ``device`` (default ``cuda``; ``"cpu"`` must be
    asked for).  Inputs as in the JAX package: x [N, D], y [N], mask [N]
    padded observations; pend [P, D], pend_mask [P]; cand [C, D],
    cand_mask [C]; hypers [chains].  ``gen`` is a torch.Generator on the
    same device.  With ``stage_times`` (a dict) the seconds of the mcmc /
    caches / ei / lbfgs stages are added to it, on the device's clock
    (``utils/trace.StageClock``: the step synchronizes once, at its
    end)."""
    return _step(gen, hypers, x, y, mask, pend, pend_mask, cand, cand_mask,
                 config, resolve_device(device), stage_times)


def _step(gen, hypers, x, y, mask, pend, pend_mask, cand, cand_mask,
          config: SuggestConfig, dev, stage_times, mesh=None):
    """``suggest_step`` on ``dev``; with ``mesh`` (``engine/mesh.Mesh``) on
    this rank's chains and candidates, returning the whole result."""

    def put(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype)

    x, y, pend, cand = put(x), put(y), put(pend), put(cand)
    mask, pend_mask = put(mask, torch.bool), put(pend_mask, torch.bool)
    cand_mask = put(cand_mask, torch.bool)
    hypers = GPHypers(*(put(a) for a in hypers))
    chains, c_all = hypers.mean.shape[0], cand.shape[0]
    kernel = config.kernel
    clock = trace.StageClock(stage_times, dev)
    shard, my_cand, reduce = None, cand, None
    if mesh is not None:
        shard = mesh.chain_shard(chains)
        if shard is not None:
            hypers = _take(hypers, slice(shard.lo, shard.hi))
        lo, hi = mesh.rows("cand", c_all)
        my_cand = cand[lo:hi]
        reduce = mesh.sum_chains

    # ---- MCMC: chains batched, mcmc_iters carried sweeps ---------------
    with _stage(clock, "mcmc"):
        h_last, flat = _sample_chains(gen, hypers, x, y, mask, config,
                                      config.mcmc._replace(chain_shard=shard))
    s = flat.mean.shape[0]

    # ---- posterior caches (one factorization per sample) ---------------
    with _stage(clock, "caches"):
        cache, x_all, mask_all = _pending_caches(
            gen, x, y, mask, pend, pend_mask, flat, config, shard)

    # ---- EI over the candidates, NaN-robust average over samples -------
    with _stage(clock, "ei"):
        ei_samples = ei_mod.ei_from_cache_chunked(cache, x_all, mask_all,
                                                  my_cand, kernel)
        if ei_samples.ndim == 3:                    # [S, C] | [S, F, C]
            ei_samples = ei_samples.mean(1)
        ok = torch.isfinite(cache.alpha.reshape(s, -1)).all(1)
        ei_mean, n_ok_true = nan_robust_mean(ei_samples, ok, reduce)
        if mesh is not None:
            ei_mean = mesh.gather("cand", ei_mean, c_all)
            h_last = GPHypers(*(mesh.gather("chains", a, chains)
                                for a in h_last))
            flat = GPHypers(*(mesh.gather("chains", a,
                                          chains * config.mcmc_iters)
                              for a in flat))
        n_ok = torch.clamp_min(n_ok_true.to(ei_mean.dtype), 1.0)
        ei_masked = torch.where(cand_mask, ei_mean, float("-inf"))
        best_cand = torch.argmax(ei_masked)
        best_cand_ei = ei_masked[best_cand]

    # ---- off-grid refinement: batched L-BFGS on the averaged EI --------
    with _stage(clock, "lbfgs"):
        if config.optimize:
            def ei_sum(pts):
                eis = ei_mod.ei_from_cache(cache, x_all, mask_all, pts,
                                           kernel)
                if eis.ndim == 3:
                    eis = eis.mean(1)
                eis = torch.where(ok[:, None] & torch.isfinite(eis), eis,
                                  0.0)
                return eis.sum(0)

            if mesh is not None:
                ei_sum = mesh.sum_chains_grad(ei_sum)
            x_opt, ei_opt, useful = _refine(
                lambda pts: -ei_sum(pts) / n_ok, cand, ei_masked, config)
        else:
            x_opt = cand[best_cand]
            ei_opt = best_cand_ei
            useful = None
    clock.close()

    return SuggestResult(
        hypers=h_last, samples=flat, ei=ei_mean, best_cand=best_cand,
        best_cand_ei=best_cand_ei, x_opt=x_opt, ei_opt=ei_opt,
        n_ok=n_ok_true, lbfgs_useful=useful)


def init_chain_states(y, mask, ndim: int, chains: int) -> GPHypers:
    """``chains`` identical reference-init states on the device of y."""
    h = init_hypers(y, mask, ndim)
    return GPHypers(*(a.expand((chains,) + a.shape).clone() for a in h))
