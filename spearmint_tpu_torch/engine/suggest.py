"""The suggestion step: MCMC → posterior caches → EI → L-BFGS.

JAX counterpart: ``spearmint_tpu/engine/suggest.py`` (``suggest_step``).

  chains × mcmc_iters batched slice-sampling sweeps (kernel B1 per
  evaluation) → one cache per sample (B2, and B3 for L⁻¹) → fantasized
  pending outcomes and augmented caches when jobs are pending → EI[S, C]
  over the candidates, NaN-robust average over samples → top-k starts →
  batched projected L-BFGS on the sample-averaged EI.

The chains axis is a leading batch axis; ``chain_chunk`` runs it in
sequential groups to bound the [group, N, N] buffers.  Shapes are padded
with masks exactly as in the JAX package.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from spearmint_tpu_torch.acquire import ei as ei_mod
from spearmint_tpu_torch.acquire.fantasy import fantasize_batch
from spearmint_tpu_torch.acquire.optimize import minimize_lbfgs_b
from spearmint_tpu_torch.core.kernels import get_kernel
from spearmint_tpu_torch.core.likelihood import GPHypers
from spearmint_tpu_torch.mcmc.chains import (
    MCMCConfig, init_hypers, marginal_at, sample_hypers_lp,
)
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
    band_joint: bool = False       # not ported (ROADMAP A11): raises

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


def nan_robust_mean(samples: torch.Tensor, ok: torch.Tensor):
    """Mean over axis 0 of the usable (``ok``, finite) samples, and n_ok."""
    n_ok_true = ok.to(torch.int32).sum()
    n_ok = torch.clamp_min(n_ok_true.to(samples.dtype), 1.0)
    ok_b = ok.reshape(ok.shape + (1,) * (samples.ndim - 1))
    samples = torch.where(ok_b & torch.isfinite(samples), samples, 0.0)
    return samples.sum(0) / n_ok, n_ok_true


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


def _mark(stage_times, name, t0, dev):
    if stage_times is None:
        return t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    now = time.perf_counter()
    stage_times[name] = stage_times.get(name, 0.0) + now - t0
    return now


def _sample_chains(gen, hypers: GPHypers, x, y, mask, config: SuggestConfig):
    """``config.mcmc_iters`` carried sweeps of every chain, in groups of
    ``chain_chunk``.  Returns (last states [chains], samples [S])."""
    h_parts, s_parts = [], []
    for sl in _groups(hypers.mean.shape[0], config.chain_chunk):
        h = _take(hypers, sl)
        lp = marginal_at(x, y, mask, h, config.mcmc)
        its = []
        for _ in range(config.mcmc_iters):
            h, lp = sample_hypers_lp(gen, h, lp, x, y, mask, config.mcmc)
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


def _refine(neg_fun, cand, masked, config: SuggestConfig):
    """Batched projected L-BFGS on the unit box from the ``grid_subset``
    best candidates of ``masked``; returns (best point, its value)."""
    starts = cand[torch.topk(masked, min(config.grid_subset,
                                         cand.shape[0])).indices]
    box = torch.zeros(cand.shape[1], dtype=cand.dtype, device=cand.device)
    res = minimize_lbfgs_b(neg_fun, starts, box, box + 1.0,
                           iters=config.lbfgs_iters)
    lane = torch.argmin(res.fun)
    return res.x[lane], -res.fun[lane]


def suggest_step(gen: torch.Generator, hypers: GPHypers, x, y, mask, pend,
                 pend_mask, cand, cand_mask,
                 config: SuggestConfig = SuggestConfig(),
                 device="cuda", stage_times: dict | None = None
                 ) -> SuggestResult:
    """One suggestion on ``device`` (default ``cuda``; ``"cpu"`` must be
    asked for).  Inputs as in the JAX package: x [N, D], y [N], mask [N]
    padded observations; pend [P, D], pend_mask [P]; cand [C, D],
    cand_mask [C]; hypers [chains].  ``gen`` is a torch.Generator on the
    same device.  With ``stage_times`` (a dict) the device is synchronized
    at each stage boundary and the seconds of the mcmc / caches / ei /
    lbfgs stages are added to it."""
    dev = resolve_device(device)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype)

    x, y, pend, cand = put(x), put(y), put(pend), put(cand)
    mask, pend_mask = put(mask, torch.bool), put(pend_mask, torch.bool)
    cand_mask = put(cand_mask, torch.bool)
    hypers = GPHypers(*(put(a) for a in hypers))
    chains = hypers.mean.shape[0]
    iters = config.mcmc_iters
    kernel = config.kernel
    t0 = time.perf_counter()

    # ---- MCMC: chains batched, mcmc_iters carried sweeps ---------------
    h_last, flat = _sample_chains(gen, hypers, x, y, mask, config)
    s = chains * iters
    t0 = _mark(stage_times, "mcmc", t0, dev)

    # ---- posterior caches (one factorization per sample) ---------------
    caches = []
    if config.has_pending:
        x_all = torch.cat([x, pend], 0)
        mask_all = torch.cat([mask, pend_mask], 0)
        n_fant = config.n_fantasies
        draws = torch.randn(s, n_fant, pend.shape[0], generator=gen,
                            dtype=x.dtype, device=dev)
        for sl in _groups(s, config.chain_chunk):
            hs = _take(flat, sl)
            fants = fantasize_batch(draws[sl], x, y, mask, pend, pend_mask,
                                    hs, kernel)                 # [g, F, P]
            y_augs = torch.cat(
                [y.expand(fants.shape[0], n_fant, -1), fants], -1)
            caches.append(ei_mod.make_cache_aug(
                x_all, mask_all, y_augs, hs, kernel,
                with_inverse=config.explicit_inverse))
        cache = _cat_caches(caches)
    else:
        x_all, mask_all = x, mask
        cache = _value_caches(x, y, mask, flat, config)
    t0 = _mark(stage_times, "caches", t0, dev)

    # ---- EI over the candidates, NaN-robust average over samples -------
    ei_samples = ei_mod.ei_from_cache_chunked(cache, x_all, mask_all, cand,
                                              kernel)   # [S, C] | [S, F, C]
    if ei_samples.ndim == 3:
        ei_samples = ei_samples.mean(1)
    ok = torch.isfinite(cache.alpha.reshape(s, -1)).all(1)
    ei_mean, n_ok_true = nan_robust_mean(ei_samples, ok)
    n_ok = torch.clamp_min(n_ok_true.to(ei_mean.dtype), 1.0)
    ei_masked = torch.where(cand_mask, ei_mean, float("-inf"))
    best_cand = torch.argmax(ei_masked)
    best_cand_ei = ei_masked[best_cand]
    t0 = _mark(stage_times, "ei", t0, dev)

    # ---- off-grid refinement: batched L-BFGS on the averaged EI --------
    if config.optimize:
        def neg_avg_ei(pts):
            eis = ei_mod.ei_from_cache(cache, x_all, mask_all, pts, kernel)
            if eis.ndim == 3:
                eis = eis.mean(1)
            eis = torch.where(ok[:, None] & torch.isfinite(eis), eis, 0.0)
            return -eis.sum(0) / n_ok

        x_opt, ei_opt = _refine(neg_avg_ei, cand, ei_masked, config)
    else:
        x_opt = cand[best_cand]
        ei_opt = best_cand_ei
    _mark(stage_times, "lbfgs", t0, dev)

    return SuggestResult(
        hypers=h_last, samples=flat, ei=ei_mean, best_cand=best_cand,
        best_cand_ei=best_cand_ei, x_opt=x_opt, ei_opt=ei_opt,
        n_ok=n_ok_true)


def init_chain_states(y, mask, ndim: int, chains: int) -> GPHypers:
    """``chains`` identical reference-init states on the device of y."""
    h = init_hypers(y, mask, ndim)
    return GPHypers(*(a.expand((chains,) + a.shape).clone() for a in h))
