"""Cost-aware suggestion: EI per expected second (dual-GP acquisition).

JAX counterpart: ``spearmint_tpu/engine/per_sec.py``
(``suggest_step_per_sec``).  A second GP is fit to the log job durations
with its own hyperparameter chains, sampled by the same slice sampler; the
acquisition is EI(x) / E[seconds](x) with E[seconds] = exp(posterior mean
of the log-duration GP), floored at 1e-3.  Pending jobs are fantasized
against the value GP exactly as in the flagship; the duration GP trains
on the completed jobs only.

The two chain families run as two [chains]-lane batches, one after the
other, as the JAX code does (two ``_chunked_vmap`` calls, not one doubled
vmap as its module docstring says): every slice evaluation of either is
one B1 call over [chains, N, N], and each family's caches are B2 (and B3
for L⁻¹).  ``chain_chunk`` and ``explicit_inverse`` apply to both.

Random streams: ``gen`` is split into three generators (value chains,
duration chains, fantasies) as the JAX code splits its key into
``k_val, k_time, k_fant``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spearmint_tpu_torch.acquire import ei as ei_mod
from spearmint_tpu_torch.core.likelihood import GPHypers
from spearmint_tpu_torch.engine.suggest import (
    SuggestConfig, _pending_caches, _refine, _sample_chains, _stage,
    _value_caches, nan_robust_mean,
)
from spearmint_tpu_torch.utils import trace
from spearmint_tpu_torch.utils.platform import resolve_device

# candidates per acquisition chunk: bounds the [S, N, chunk] temporaries
# of both families (ei.ei_from_cache_chunked's default)
ACQ_CHUNK = 512
# E[seconds] floor: no division blow-up for predicted sub-millisecond jobs
MIN_SECONDS = 1e-3


class PerSecResult(NamedTuple):
    hypers: GPHypers         # [chains] value-GP chain states
    time_hypers: GPHypers    # [chains] duration-GP chain states
    ei_per_s: torch.Tensor   # [C] sample-averaged EI/sec on candidates
    best_cand: torch.Tensor
    best_cand_ei: torch.Tensor
    x_opt: torch.Tensor
    ei_opt: torch.Tensor
    n_ok: torch.Tensor = None        # samples whose caches of both
                                     # families are finite
    samples: GPHypers = None         # [S] this call's value samples
    time_samples: GPHypers = None    # [S] this call's duration samples
    lbfgs_useful: torch.Tensor = None  # L-BFGS's useful_iters; None
                                       # where no refinement ran


def split_generator(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` independent generators on ``gen``'s device, seeded from it."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen, device=gen.device)
    out = []
    for seed in seeds.tolist():
        g = torch.Generator(device=gen.device)
        g.manual_seed(seed)
        out.append(g)
    return out


def suggest_step_per_sec(gen: torch.Generator, hypers: GPHypers,
                         time_hypers: GPHypers, x, y, log_durs, mask, pend,
                         pend_mask, cand, cand_mask,
                         config: SuggestConfig = SuggestConfig(),
                         device="cuda", stage_times: dict | None = None
                         ) -> PerSecResult:
    """One cost-aware suggestion on ``device`` (default ``cuda``; ``"cpu"``
    must be asked for).  Inputs as ``engine.suggest.suggest_step``'s, plus
    ``time_hypers`` [chains] (the duration GP's chain states) and
    ``log_durs`` [N] (log durations under the observations' mask).  With
    ``stage_times`` (a dict) the seconds of the mcmc / caches / ei / lbfgs
    stages are added to it, as ``suggest_step`` adds them."""
    dev = resolve_device(device)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype)

    x, y, log_durs, pend, cand = (put(a) for a in (x, y, log_durs, pend,
                                                   cand))
    mask, pend_mask = put(mask, torch.bool), put(pend_mask, torch.bool)
    cand_mask = put(cand_mask, torch.bool)
    hypers = GPHypers(*(put(a) for a in hypers))
    time_hypers = GPHypers(*(put(a) for a in time_hypers))
    kernel = config.kernel
    g_val, g_time, g_fant = split_generator(gen, 3)
    clock = trace.StageClock(stage_times, dev)

    # ---- MCMC: the two chain families, one [chains] batch each ---------
    with _stage(clock, "mcmc"):
        h_last, flat = _sample_chains(g_val, hypers, x, y, mask, config)
        t_last, t_flat = _sample_chains(g_time, time_hypers, x, log_durs,
                                        mask, config)
    s = flat.mean.shape[0]

    # ---- caches: value GP (fantasies when pending), duration GP --------
    with _stage(clock, "caches"):
        cache, x_all, mask_all = _pending_caches(g_fant, x, y, mask, pend,
                                                 pend_mask, flat, config)
        t_cache = _value_caches(x, log_durs, mask, t_flat, config)
        # a sample counts only if both families' factorizations are finite
        ok = (torch.isfinite(cache.alpha.reshape(s, -1)).all(1)
              & torch.isfinite(t_cache.alpha.reshape(s, -1)).all(1))

    def ei_per_s_at(pts):
        """[S] sample-paired EI/sec at pts [C', D] → [S, C']."""
        eis = ei_mod.ei_from_cache(cache, x_all, mask_all, pts, kernel)
        if eis.ndim == 3:
            # E[seconds] does not depend on the fantasy, so averaging EI
            # over the fantasy axis first is the mean of EI/sec
            eis = eis.mean(1)
        mus = ei_mod.posterior_from_cache(t_cache, x, mask, pts, kernel)[0]
        return eis / torch.clamp_min(torch.exp(mus), MIN_SECONDS)

    # ---- EI/sec over the candidates, NaN-robust average over samples ---
    with _stage(clock, "ei"):
        starts = range(0, cand.shape[0], ACQ_CHUNK)
        trace.count("ei:chunks", len(starts))
        per_s = torch.cat([ei_per_s_at(cand[i:i + ACQ_CHUNK])
                           for i in starts], -1)
        ei_mean, n_ok_true = nan_robust_mean(per_s, ok)
        n_ok = torch.clamp_min(n_ok_true.to(ei_mean.dtype), 1.0)
        ei_masked = torch.where(cand_mask, ei_mean, float("-inf"))
        best_cand = torch.argmax(ei_masked)
        best_cand_ei = ei_masked[best_cand]

    # ---- off-grid refinement: batched L-BFGS on the averaged EI/sec ----
    with _stage(clock, "lbfgs"):
        if config.optimize:
            def neg_avg(pts):
                eis = ei_per_s_at(pts)
                eis = torch.where(ok[:, None] & torch.isfinite(eis), eis, 0.0)
                return -eis.sum(0) / n_ok

            x_opt, ei_opt, useful = _refine(neg_avg, cand, ei_masked,
                                            config)
        else:
            x_opt, ei_opt, useful = cand[best_cand], best_cand_ei, None
    clock.close()

    return PerSecResult(
        hypers=h_last, time_hypers=t_last, ei_per_s=ei_mean,
        best_cand=best_cand, best_cand_ei=best_cand_ei, x_opt=x_opt,
        ei_opt=ei_opt, n_ok=n_ok_true, samples=flat, time_samples=t_flat,
        lbfgs_useful=useful)
