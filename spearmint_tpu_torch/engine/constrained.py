"""Constrained EI: a probit latent-GP constraint classifier weighting EI.

JAX counterpart: ``spearmint_tpu/engine/constrained.py``.  Evaluations
whose objective came back NaN violate a constraint and carry the label
z = −1 (valid ones z = +1).  A latent GP f with the probit likelihood
P(valid | f) = Φ(f) classifies the space, and the acquisition is

    EI_valid(x) · Φ( μ_f(x) / sqrt(1 + σ²_f(x)) )

with EI_valid the ordinary EI over the valid observations only.

One constraint sweep per chain and iteration (``_sample_constraint``):
four elliptical-slice moves of the latent values against the library
Cholesky of the prior covariance; a component-wise slice move of the
length scales whose every evaluation assembles the [K, N, N] covariance
and factors it in kernel B4a (``linalg.chol_logdet_q``); and a slice move
of amp2 in closed form off one library factorization of the unit
covariance.  The constraint caches factor through ``linalg.cache_factor``
(B2 + B3), the value GP runs as in ``engine/suggest`` (B1, B2, B3).

The JAX vmap over chains is the leading batch axis; ``chain_chunk`` runs
chains and samples in groups (``engine.suggest._groups``).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from spearmint_tpu_torch.acquire import ei as ei_mod
from spearmint_tpu_torch.core import linalg, priors
from spearmint_tpu_torch.core.kernels import matern52
from spearmint_tpu_torch.core.likelihood import (
    GPHypers, _effective_jitter, unit_cov_matrix,
)
from spearmint_tpu_torch.engine.suggest import (
    SuggestConfig, _cat, _groups, _mark, _refine,
    _sample_chains, _stack_iters, _take, _value_caches, nan_robust_mean,
)
from spearmint_tpu_torch.mcmc.ess import elliptical_slice
from spearmint_tpu_torch.mcmc.slice import slice_sample
from spearmint_tpu_torch.utils.platform import resolve_device

ESS_SWEEPS = 4
# candidates per acquisition chunk: bounds the [S, N, chunk] temporaries
ACQ_CHUNK = 512


class ConstraintState(NamedTuple):
    """Constraint-model states, leading batch axis K on every field."""

    ls: torch.Tensor    # [K, D] constraint-GP length scales
    amp2: torch.Tensor  # [K] amplitude
    ff: torch.Tensor    # [K, N] latent values at the observed points


class ConstrainedResult(NamedTuple):
    hypers: GPHypers             # [chains] value-GP states
    constraint: ConstraintState  # [chains] constraint states
    acq: torch.Tensor            # [C] weighted acquisition on candidates
    p_valid: torch.Tensor        # [C] mean feasibility probability
    best_cand: torch.Tensor
    best_cand_acq: torch.Tensor
    x_opt: torch.Tensor
    acq_opt: torch.Tensor
    n_ok: torch.Tensor           # samples whose value AND constraint
                                 # caches are finite
    samples: GPHypers            # [S] this call's value samples
    c_samples: ConstraintState   # [S] this call's constraint samples


class ConstraintCache(NamedTuple):
    """Per-sample constraint-GP factorization reused by every acquisition
    evaluation (grid sweep and each L-BFGS step)."""

    state: ConstraintState
    linv: torch.Tensor   # [S, N, N] explicit L⁻¹ of the constraint cov
    alpha: torch.Tensor  # [S, N] K⁻¹ ff


# ------------------------------------------------------------ the model
def _constraint_cov(x, mask, ls, amp2, kernel=matern52):
    """amp2·(k(X, X) + jitter·I), padded rows/cols identity; ls [K, D],
    amp2 [K] → [K, N, N].  ``_effective_jitter``: the constraint GP has
    no noise term, so at large n it needs the value GP's conditioning
    floor."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = amp2[:, None, None] * (kernel(x, x, ls) + _effective_jitter(n) * eye)
    return linalg.mask_psd_matrix(k, mask)


def _constraint_unit_cov(x, mask, ls, kernel=matern52):
    """k(X, X) + jitter·I with padded rows/cols zero: the value GP's
    unit covariance M, so K = amp2·M + diag(where(mask, 0, 1))."""
    return unit_cov_matrix(x, mask, ls, kernel)


def _probit_loglik(ff, z, mask):
    """Σ log Φ(z·f) over the observed points, per lane: ff [K, N] → [K]."""
    lp = torch.special.log_ndtr(z * ff)
    return torch.where(mask, lp, 0.0).sum(-1)


def _ls_logprob(ls, x, mask, amp2, ff, kernel, max_ls):
    """Log density of the constraint length scales [K, D] under the latent
    values' GP prior and the tophat prior: one B4a evaluation."""
    valid = priors.ls_in_bounds(ls, max_ls)
    ls_s = torch.clamp(ls, 1e-6, max_ls)
    ld, q = linalg.chol_logdet_q(_constraint_cov(x, mask, ls_s, amp2, kernel),
                                 ff)
    lp = -ld - 0.5 * q
    lp = torch.where(torch.isnan(lp), float("-inf"), lp)
    return torch.where(valid, lp, float("-inf"))


def _unit_terms(x, mask, ls_s, ff, kernel):
    """(½ log det M, ffᵀM⁻¹ff) per lane from one library factorization of
    the unit covariance M (padded diagonal 1 → adds 0)."""
    unit = _constraint_cov(x, mask, ls_s, torch.ones_like(ls_s[:, 0]), kernel)
    chu = linalg.cholesky(unit)
    wu = linalg.tri_solve(chu, ff[..., None])[..., 0]
    return linalg.logdet_from_chol(chu), (wu * wu).sum(-1)


def _amp2_logprob(a, n_eff, half_logdet_unit, quad):
    """Closed-form log density of amp2 [K, 1] for K = amp2·M: the GP prior
    of the latent values plus the lognormal amplitude prior."""
    a = a[:, 0]
    valid = a > 0.0
    a_s = torch.where(valid, a, 1.0)
    lp = (-0.5 * n_eff * torch.log(a_s) - half_logdet_unit
          - 0.5 * quad / a_s + priors.lognormal_amp2_term(a_s))
    lp = torch.where(torch.isnan(lp), float("-inf"), lp)
    return torch.where(valid, lp, float("-inf"))


def _sample_constraint(gen, state: ConstraintState, x, z, mask, kernel,
                       max_ls, ess_sweeps=ESS_SWEEPS) -> ConstraintState:
    """One constraint sweep of every lane: latent ESS moves, the ls slice
    move, then the amp2 slice move (the reference samples the constraint
    GP's amp2 with the value GP's lognormal prior)."""
    chol = linalg.cholesky(_constraint_cov(x, mask, state.ls, state.amp2,
                                           kernel))
    ff = state.ff
    for _ in range(ess_sweeps):
        ff = elliptical_slice(gen, ff, chol,
                              lambda f: _probit_loglik(f, z, mask))
    del chol
    ff = torch.where(mask, ff, 0.0)

    ls, _ = slice_sample(
        gen, state.ls,
        lambda v: _ls_logprob(v, x, mask, state.amp2, ff, kernel, max_ls),
        compwise=True)

    # amp2 move: K = amp2·M with M fixed by the new ls, so every slice
    # evaluation is closed-form off ONE factorization of M
    half_logdet_unit, quad = _unit_terms(
        x, mask, torch.clamp(ls, 1e-6, max_ls), ff, kernel)
    n_eff = mask.to(x.dtype).sum()
    amp2, _ = slice_sample(
        gen, state.amp2[:, None],
        lambda a: _amp2_logprob(a, n_eff, half_logdet_unit, quad),
        compwise=True)
    return ConstraintState(ls=ls, amp2=amp2[:, 0], ff=ff)


def burnin_constraint_states(gen, constraint: ConstraintState, x, z, mask,
                             steps: int, kernel=matern52,
                             max_ls: float = priors.MAX_LS
                             ) -> ConstraintState:
    """``steps`` constraint sweeps of every chain (the reference burns in
    all chooser state before its first suggestion)."""
    for _ in range(steps):
        constraint = _sample_constraint(gen, constraint, x, z, mask, kernel,
                                        max_ls)
    return constraint


def _make_constraint_cache(state: ConstraintState, x, mask,
                           kernel=matern52) -> ConstraintCache:
    """Factor K = amp2·M exactly (no noise term; dadd = 1 on padded rows
    only) through the value GP's cache route: B2, then B3 for L⁻¹."""
    m0 = _constraint_unit_cov(x, mask, state.ls, kernel)
    dadd = torch.where(mask, 0.0, 1.0).to(x.dtype).expand(
        state.amp2.shape[0], -1)
    _, linv, alpha = linalg.cache_factor(m0, state.amp2, dadd, state.ff)
    return ConstraintCache(state=state, linv=linv, alpha=alpha)


def _p_valid_from_cache(cache: ConstraintCache, x, mask, cand,
                        kernel=matern52):
    """Probit predictive feasibility [S, C] at candidates [C, D].  The β
    product runs in full float32 (the JAX package allows bf16_3x here)."""
    st = cache.state
    kx = st.amp2[:, None, None] * kernel(x, cand, st.ls) * mask[:, None]
    mu = (cache.alpha[:, None, :] @ kx)[:, 0]
    beta = cache.linv @ kx
    # the prior variance carries the jitter the covariance was assembled
    # with (_constraint_cov)
    var = (st.amp2[:, None] * (1.0 + _effective_jitter(x.shape[0]))
           - (beta * beta).sum(-2))
    var = torch.clamp_min(var, 1e-10)
    return torch.special.ndtr(mu / torch.sqrt(1.0 + var))


def _p_valid_at(state: ConstraintState, x, mask, cand, kernel=matern52):
    """One-shot probit feasibility: build the cache and evaluate."""
    return _p_valid_from_cache(_make_constraint_cache(state, x, mask, kernel),
                               x, mask, cand, kernel)


def _constraint_caches(c_flat: ConstraintState, x, mask, kernel, chunk):
    parts = [_make_constraint_cache(_take(c_flat, sl), x, mask, kernel)
             for sl in _groups(c_flat.amp2.shape[0], chunk)]
    if len(parts) == 1:
        return parts[0]
    return ConstraintCache(state=_cat([p.state for p in parts]),
                           linv=torch.cat([p.linv for p in parts]),
                           alpha=torch.cat([p.alpha for p in parts]))


# ------------------------------------------------------------ the step
def suggest_step_constrained(
    gen: torch.Generator,
    hypers: GPHypers,               # [chains] value-GP states
    constraint: ConstraintState,    # [chains] constraint states
    x, y,                           # [N, D] all observed points, [N]
    valid_mask, obs_mask,           # [N] finite objective / any completed
    cand, cand_mask,                # [C, D], [C]
    config: SuggestConfig = SuggestConfig(),
    device="cuda", stage_times: dict | None = None,
) -> ConstrainedResult:
    """One constrained suggestion on ``device`` (default ``cuda``;
    ``"cpu"`` must be asked for).  Inputs as in the JAX package, padded
    with masks; y is 0 where invalid or padded.  ``gen`` is a
    torch.Generator on the same device.  With ``stage_times`` (a dict) the
    device is synchronized at each stage boundary and the seconds of the
    mcmc / constraint / caches / acq / lbfgs stages are added to it."""
    dev = resolve_device(device)

    def put(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype)

    x, y, cand = put(x), put(y), put(cand)
    valid_mask, obs_mask = put(valid_mask, torch.bool), put(obs_mask,
                                                             torch.bool)
    cand_mask = put(cand_mask, torch.bool)
    hypers = GPHypers(*(put(a) for a in hypers))
    constraint = ConstraintState(*(put(a) for a in constraint))
    chains = hypers.mean.shape[0]
    kernel = config.kernel
    z = torch.where(valid_mask, 1.0, -1.0).to(x.dtype)
    t0 = time.perf_counter()

    # ---- value GP over the valid observations --------------------------
    h_last, flat = _sample_chains(gen, hypers, x, y, valid_mask, config)
    t0 = _mark(stage_times, "mcmc", t0, dev)

    # ---- constraint model over all observations ------------------------
    c_parts, cs_parts = [], []
    for sl in _groups(chains, config.chain_chunk):
        c = _take(constraint, sl)
        its = []
        for _ in range(config.mcmc_iters):
            c = _sample_constraint(gen, c, x, z, obs_mask, kernel,
                                   config.max_ls)
            its.append(c)
        c_parts.append(c)
        cs_parts.append(_stack_iters(its))
    c_last, c_flat = _cat(c_parts), _cat(cs_parts)
    t0 = _mark(stage_times, "constraint", t0, dev)

    # ---- one factorization per sample and model ------------------------
    caches = _value_caches(x, y, valid_mask, flat, config)
    c_caches = _constraint_caches(c_flat, x, obs_mask, kernel,
                                  config.chain_chunk)
    # NaN-robust average: a sample whose value or constraint cache failed
    # at the f32 conditioning edge drops out
    ok = (torch.isfinite(caches.alpha).all(1)
          & torch.isfinite(c_caches.alpha).all(1))
    t0 = _mark(stage_times, "caches", t0, dev)

    def acq_at(pts):
        pv = _p_valid_from_cache(c_caches, x, obs_mask, pts, kernel)
        return ei_mod.ei_from_cache(caches, x, valid_mask, pts, kernel) * pv, pv

    parts = [acq_at(cand[i:i + ACQ_CHUNK])
             for i in range(0, cand.shape[0], ACQ_CHUNK)]
    acq_mean, n_ok_true = nan_robust_mean(torch.cat([a for a, _ in parts], -1),
                                          ok)
    pv_mean, _ = nan_robust_mean(torch.cat([p for _, p in parts], -1), ok)
    n_ok = torch.clamp_min(n_ok_true.to(x.dtype), 1.0)
    acq_masked = torch.where(cand_mask, acq_mean, float("-inf"))
    best_cand = torch.argmax(acq_masked)
    best_cand_acq = acq_masked[best_cand]
    t0 = _mark(stage_times, "acq", t0, dev)

    if config.optimize:
        def neg_acq(pts):
            a, _ = acq_at(pts)
            a = torch.where(ok[:, None] & torch.isfinite(a), a, 0.0)
            return -a.sum(0) / n_ok

        x_opt, acq_opt = _refine(neg_acq, cand, acq_masked, config)
    else:
        x_opt, acq_opt = cand[best_cand], best_cand_acq
    _mark(stage_times, "lbfgs", t0, dev)

    return ConstrainedResult(
        hypers=h_last, constraint=c_last, acq=acq_mean, p_valid=pv_mean,
        best_cand=best_cand, best_cand_acq=best_cand_acq, x_opt=x_opt,
        acq_opt=acq_opt, n_ok=n_ok_true, samples=flat, c_samples=c_flat)


def init_constraint_states(ndim: int, n_pad: int, chains: int,
                           device="cuda",
                           dtype=torch.float32) -> ConstraintState:
    """``chains`` identical initial states: ls = 1, amp2 = 1, ff = 0."""
    dev = resolve_device(device)
    return ConstraintState(
        ls=torch.ones((chains, ndim), dtype=dtype, device=dev),
        amp2=torch.ones((chains,), dtype=dtype, device=dev),
        ff=torch.zeros((chains, n_pad), dtype=dtype, device=dev))
