"""Observation-axis sharded GP primitives and the large-n suggestion.

JAX counterpart: ``spearmint_tpu/engine/obs_shard.py``.  The n×n working
set of a GP exists only as column slabs spread over the ranks of a process
group: rank j of ``size`` holds the [K, N, N/size] slab of columns
[j·Nl, (j+1)·Nl) of every lane's matrix (K lanes: chains or samples, a
leading batch axis, where the JAX code vmaps over them inside
``shard_map``) and every vector replicated.

  * ``cov_colblock``        my slab of amp2·(k(X,X) + εI) + noise·I, with
                            identity rows and columns on pads;
  * ``cholesky_colblock``   right-looking Cholesky over the slabs;
  * ``solve_colblock``      forward substitution, replicated result;
  * ``logprob_colblock``    GP log-marginal from the slabs;
  * ``posterior_colblock``  posterior mean/var at replicated candidates;
  * ``sharded_suggest_obs``, ``sharded_suggest_per_sec``  the large-n
    suggestion steps (BASELINE config 5) built on them.

The Cholesky, in PyTorch's idiom::

  for k in 0..size-1:                  # right-looking
    owner k factors its panel          # chol of its diagonal block + one
                                       # triangular solve of the rows below
    broadcast(panel_k, src=k)          # rows ≥ k·Nl only (above are zero)
    j > k:  slab -= panel_k @ panel_k[my rows]ᵀ      # trailing update

The JAX code makes every device factor its slab "as if active" and
broadcasts with a masked ``psum`` (``_bcast_from``), because
``shard_map`` must stay SPMD-uniform; here only the owner factors and
``dist.broadcast`` moves its panel.  The numbers are the same.  The last
panel, and the last update of a forward solve, feed no rank and are not
broadcast.  The log-det sum is an ``all_reduce``.

Every rank computes the same log-marginal bit for bit (the solves'
results are broadcast, the log-det all-reduced), so the slice sampler,
which branches on it, takes the same path on every rank and the ranks
make the same collective calls.  A rank that diverges fails at the
process group's timeout (``engine/distributed.TIMEOUT``).

The obs path runs no hand-written kernel: its factorizations are
``torch.linalg`` calls on slab blocks, as its JAX twin runs XLA's and no
Pallas.
"""

from __future__ import annotations

import functools
import math
import time
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from spearmint_tpu_torch.core.kernels import matern52
from spearmint_tpu_torch.core.likelihood import GPHypers, _effective_jitter
from spearmint_tpu_torch.engine.per_sec import (
    MIN_SECONDS, PerSecResult, split_generator,
)
from spearmint_tpu_torch.engine.suggest import (
    SuggestResult, _groups, _sample_chains, _stage, _take, nan_robust_mean,
)
from spearmint_tpu_torch.mcmc.chains import MCMCConfig, sample_hypers
from spearmint_tpu_torch.utils import trace
from spearmint_tpu_torch.utils.platform import resolve_device

# candidates per EI chunk: bounds the [K, N, chunk] solves (the JAX
# package's cand_chunk)
CAND_CHUNK = 4096


class ObsMesh(NamedTuple):
    """The ranks of a process group as the `obs` axis (the JAX package's
    1-D ``obs`` mesh).  ``stats`` (a dict, or None) counts the collectives
    (calls, bytes moved, seconds with the device synchronized first) and
    the marginal evaluations."""

    group: object            # process group; None: the default one
    rank: int                # my index in the group
    size: int
    ranks: tuple             # the group's global ranks, by index
    device: torch.device
    stats: dict | None = None


def make_obs_mesh(group=None, device="cuda", stats: dict | None = None
                  ) -> ObsMesh:
    """Every rank of ``group`` (default: the default group; without one, a
    mesh of this process alone) on ``device`` (``cuda`` unless the CPU is
    asked for)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return ObsMesh(None, 0, 1, (0,), dev, stats)
    ranks = tuple(dist.get_process_group_ranks(group or dist.group.WORLD))
    return ObsMesh(group, dist.get_rank(group), len(ranks), ranks, dev,
                   stats)


def _collective(mesh: ObsMesh, op, t: torch.Tensor) -> torch.Tensor:
    """Run ``op(t)`` (in place), counted in ``mesh.stats``."""
    if mesh.stats is None:
        op(t)
        return t
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    op(t)
    st = mesh.stats
    st["collective_s"] = st.get("collective_s", 0.0) + (
        time.perf_counter() - t0)
    st["collective_calls"] = st.get("collective_calls", 0) + 1
    st["collective_bytes"] = (st.get("collective_bytes", 0)
                              + t.numel() * t.element_size())
    return t


def _bcast(mesh: ObsMesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` of rank ``src`` (a group index) on every rank."""
    if mesh.size == 1:
        return t
    t = t.contiguous()
    return _collective(mesh, lambda a: dist.broadcast(
        a, src=mesh.ranks[src], group=mesh.group), t)


def _allsum(mesh: ObsMesh, t: torch.Tensor) -> torch.Tensor:
    if mesh.size == 1:
        return t
    return _collective(mesh, lambda a: dist.all_reduce(a, group=mesh.group),
                       t)


def _width(mesh: ObsMesh, n: int) -> int:
    if n % mesh.size:
        raise ValueError(f"pad {n} is not a multiple of {mesh.size} ranks")
    return n // mesh.size


# --------------------------------------------------------------- assembly
def cov_colblock(mesh: ObsMesh, x, mask, amp2, noise, ls,
                 kernel: Callable = matern52):
    """My [K, N, Nl] column slab of amp2·(k(X,X) + εI) + noise·I.

    Padded rows/cols (mask False) are identity rows, as
    ``core/linalg.mask_psd_matrix`` makes them, so the sharded
    factorization of a padded matrix equals the unsharded one.  amp2,
    noise [K]; ls [K, D]; x/mask replicated [N, D]/[N]."""
    n = x.shape[0]
    nl = _width(mesh, n)
    col0 = mesh.rank * nl
    k = kernel(x, x[col0:col0 + nl], ls)                        # [K, N, Nl]
    rows = torch.arange(n, device=x.device)[:, None]
    cols = torch.arange(nl, device=x.device)[None, :] + col0
    on_diag = (rows == cols).to(x.dtype)
    k = (amp2[:, None, None] * (k + _effective_jitter(n) * on_diag)
         + noise[:, None, None] * on_diag)
    both = mask[:, None] & mask[None, col0:col0 + nl]
    return torch.where(both, k, on_diag)


# ------------------------------------------------------------- cholesky
def _factor_panel(slab, row0: int, nl: int):
    """The active panel of my slab: rows [row0, N) of L's columns, the
    Cholesky of my diagonal block above the rows below it solved against
    its transpose.  A lane whose block is not positive definite is NaN
    (``torch.linalg.cholesky`` raises where ``jnp.linalg.cholesky`` gives
    NaN; the NaN reaches the lane's lp, which becomes −inf)."""
    l_dd, info = torch.linalg.cholesky_ex(slab[:, row0:row0 + nl])
    bad = (info != 0) | ~torch.isfinite(l_dd).all(-1).all(-1)
    l_dd = torch.where(bad[:, None, None], float("nan"), l_dd)
    below = torch.linalg.solve_triangular(
        l_dd.mT, slab[:, row0 + nl:], upper=True, left=False)
    return torch.cat([l_dd, below], 1)


def cholesky_colblock(mesh: ObsMesh, a_col):
    """Distributed lower Cholesky of a PSD matrix in column slabs.

    ``a_col``: my [K, N, Nl] slab.  Returns my slab of L (entries above
    the diagonal zero)."""
    kk, n, nl = a_col.shape
    j = mesh.rank
    row0 = j * nl
    slab = a_col.clone()
    for k in range(mesh.size):
        rk = k * nl
        last = k == mesh.size - 1
        if j == k:
            panel = _factor_panel(slab, rk, nl)          # [K, N − rk, Nl]
            slab[:, :rk] = 0.0
            slab[:, rk:] = panel
        elif not last:
            panel = torch.empty(kk, n - rk, nl, dtype=slab.dtype,
                                device=slab.device)
        if last:
            break          # the last panel feeds no rank
        panel = _bcast(mesh, panel, k)
        if j > k:
            mine = panel[:, row0 - rk:]                  # my rows ≥ row0
            slab[:, row0:] -= mine @ mine[:, :nl].mT
    return slab


def _diag_block(mesh: ObsMesh, l_col):
    nl = l_col.shape[-1]
    row0 = mesh.rank * nl
    return l_col[:, row0:row0 + nl]


# ---------------------------------------------------------------- solves
def solve_colblock(mesh: ObsMesh, l_col, b):
    """Forward substitution L z = b with L in column slabs.

    ``b``: replicated [K, N] or [K, N, C].  Returns replicated z of the
    same shape.  At step k the owner of block k solves its diagonal system
    and broadcasts its solution slice with its column's contribution to
    the later rows (one broadcast)."""
    vec = b.ndim == 2
    if vec:
        b = b[..., None]
    kk, n, nl = l_col.shape
    resid = b.clone()
    z = torch.empty_like(b)
    for k in range(mesh.size):
        rk = k * nl
        rows = nl if k == mesh.size - 1 else n - rk   # the last update
                                                      # feeds no rank
        if mesh.rank == k:
            zk = torch.linalg.solve_triangular(
                _diag_block(mesh, l_col), resid[:, rk:rk + nl], upper=False)
            buf = (zk if rows == nl else
                   torch.cat([zk, l_col[:, rk + nl:] @ zk], 1))
        else:
            buf = torch.empty(kk, rows, b.shape[-1], dtype=b.dtype,
                              device=b.device)
        buf = _bcast(mesh, buf, k)
        z[:, rk:rk + nl] = buf[:, :nl]
        resid[:, rk + nl:] -= buf[:, nl:]
    return z[..., 0] if vec else z


def _backsolve(mesh: ObsMesh, l_col, z):
    """Backward substitution Lᵀ w = z (z, w replicated [K, N]).

    The block pipeline in reverse: Lᵀ's row block k is L's column slab k
    transposed, so each step is local to its owner, which broadcasts its
    slice of w."""
    kk, n, nl = l_col.shape
    w = torch.zeros_like(z)
    for k in reversed(range(mesh.size)):
        rk = k * nl
        if mesh.rank == k:
            r = z[:, rk:rk + nl] - (l_col[:, rk + nl:].mT
                                    @ w[:, rk + nl:, None])[..., 0]
            wk = torch.linalg.solve_triangular(
                _diag_block(mesh, l_col).mT, r[..., None], upper=True)[..., 0]
        else:
            wk = torch.empty(kk, nl, dtype=z.dtype, device=z.device)
        w[:, rk:rk + nl] = _bcast(mesh, wk, k)
    return w


# --------------------------------------------------------- log marginal
def logprob_colblock(mesh: ObsMesh, x, y, mask, mean, amp2, noise, ls,
                     kernel: Callable = matern52):
    """GP log-marginal [K] (reference logprob semantics, the 2π constant
    dropped, as ``core/likelihood.log_marginal``) from obs-sharded blocks;
    x/y/mask replicated, hypers [K]."""
    l_col = cholesky_colblock(
        mesh, cov_colblock(mesh, x, mask, amp2, noise, ls, kernel))
    logdet_half = _allsum(
        mesh, torch.log(torch.diagonal(_diag_block(mesh, l_col), 0, -2, -1)
                        ).sum(-1))
    resid = torch.where(mask, y - mean[:, None], 0.0)
    zed = solve_colblock(mesh, l_col, resid)
    return -logdet_half - 0.5 * (zed * zed).sum(-1)


def _marginal_colblock(mesh: ObsMesh, x, y, mask, hypers: GPHypers,
                       kernel=matern52):
    """``core.likelihood.log_marginal`` drop-in, obs-sharded, with the same
    NaN→−inf guard (a failed factorization is zero probability, not a
    poisoned chain)."""
    if mesh.stats is not None:
        mesh.stats["marginals"] = mesh.stats.get("marginals", 0) + 1
    lp = logprob_colblock(mesh, x, y, mask, hypers.mean, hypers.amp2,
                          hypers.noise, hypers.ls, kernel)
    return torch.where(torch.isnan(lp), float("-inf"), lp)


# ------------------------------------------------------------- posterior
def _cross(x, mask, h: GPHypers, cand, kernel):
    """amp2·k(X, C) with padded rows zeroed, [K, N, C]."""
    return h.amp2[:, None, None] * kernel(x, cand, h.ls) * mask[:, None]


def _prior_var(h: GPHypers, n: int):
    """The prior variance with the jitter the covariance was assembled
    with (``_effective_jitter``, as ``acquire/ei.posterior_from_cache``)."""
    return h.amp2[:, None] * (1.0 + _effective_jitter(n))


def posterior_colblock(mesh: ObsMesh, x, y, mask, cand, mean, amp2, noise,
                       ls, kernel: Callable = matern52):
    """Posterior mean/var [K, C] at replicated candidates from sharded
    blocks: m = mean + k*ᵀK⁻¹(y−mean), v = amp2(1+ε) − Σ(L⁻¹k*)²."""
    h = GPHypers(mean, amp2, noise, ls)
    l_col = cholesky_colblock(
        mesh, cov_colblock(mesh, x, mask, amp2, noise, ls, kernel))
    kx = _cross(x, mask, h, cand, kernel)
    resid = torch.where(mask, y - mean[:, None], 0.0)
    alpha = _backsolve(mesh, l_col, solve_colblock(mesh, l_col, resid))
    mu = mean[:, None] + (alpha[:, None, :] @ kx)[:, 0]
    beta = solve_colblock(mesh, l_col, kx)
    return mu, _prior_var(h, x.shape[0]) - (beta * beta).sum(-2)


# ------------------------------------------------------------ public API
def use_obs_gate(obs_shard_min: int, ndev: int, pad: int,
                 n_pending: int) -> bool:
    """The obs-mesh routing decision shared by the GP choosers
    (GPEIOptChooser and GPEIperSecChooser): shard the n×n working set over
    the ranks once the pad reaches ``obs_shard_min`` with several ranks
    whose count divides the pad.  Pending jobs fall back to the chains
    path (fantasization lives there)."""
    return (obs_shard_min > 0 and ndev > 1 and pad >= obs_shard_min
            and pad % ndev == 0 and n_pending == 0)


def sharded_logprob(mesh: ObsMesh, kernel: Callable = matern52):
    """The obs-sharded log-marginal as a callable (x, y, mask, mean, amp2,
    noise, ls) → [K]."""
    return functools.partial(logprob_colblock, mesh, kernel=kernel)


def _obs_mcmc(mesh: ObsMesh, config):
    """``config.mcmc`` with the obs-sharded marginal.  Band mode off: the
    banded joint move would assemble the full n×n M on every rank, which
    the obs path exists never to do."""
    return config._replace(marginal=functools.partial(_marginal_colblock,
                                                      mesh),
                           band_joint=False)


def sharded_sample_hypers(mesh: ObsMesh, config=None):
    """One slice-sampling sweep of every chain with each GP log-marginal
    evaluation obs-sharded: the regime of fewer chains than ranks, where a
    chain's O(n³) likelihood work spreads over the group.  Returns a
    callable (gen, hypers, x, y, mask) → GPHypers, replicated."""
    cfg = _obs_mcmc(mesh, config or MCMCConfig())
    return lambda gen, hypers, x, y, mask: sample_hypers(
        gen, hypers, x, y, mask, cfg)


def sharded_posterior(mesh: ObsMesh, kernel: Callable = matern52):
    """The obs-sharded posterior as a callable (x, y, mask, cand, mean,
    amp2, noise, ls) → (mu, var) [K, C]."""
    return functools.partial(posterior_colblock, mesh, kernel=kernel)


# ---------------------------------------- shared suggestion-step pieces
def _chunk_candidates(cand, chunk: int = CAND_CHUNK):
    """The candidates in chunks of ``chunk`` rows (the last may be short:
    eager calls need no uniform shape, unlike the JAX ``lax.map``)."""
    return torch.split(cand, chunk)


def _value_pieces(mesh: ObsMesh, x, data, mask, h: GPHypers, kernel):
    """One factorization bundle per lane of h: (l_col, alpha =
    K⁻¹(data − mean), ok = alpha finite)."""
    l_col = cholesky_colblock(
        mesh, cov_colblock(mesh, x, mask, h.amp2, h.noise, h.ls, kernel))
    resid = torch.where(mask, data - h.mean[:, None], 0.0)
    alpha = _backsolve(mesh, l_col, solve_colblock(mesh, l_col, resid))
    return l_col, alpha, torch.isfinite(alpha).all(-1)


def _ei_chunk(mesh: ObsMesh, x, mask, h: GPHypers, l_col, alpha, best, cc,
              kernel):
    """EI [K, c] at one candidate chunk from an obs-sharded bundle — the
    one obs-path EI formula (``acquire/ei`` semantics)."""
    kx = _cross(x, mask, h, cc, kernel)
    mu = h.mean[:, None] + (alpha[:, None, :] @ kx)[:, 0]
    beta = solve_colblock(mesh, l_col, kx)
    var = _prior_var(h, x.shape[0]) - (beta * beta).sum(-2)
    sigma = torch.sqrt(torch.clamp_min(var, 1e-14))
    u = (best - mu) / sigma
    return sigma * (u * torch.special.ndtr(u)
                    + torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi))


def _put_all(dev, hypers_list, arrays, bools):
    def put(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype)

    return ([GPHypers(*(put(a) for a in h)) for h in hypers_list],
            [put(a) for a in arrays], [put(a, torch.bool) for a in bools])


def _argmax_result(ei_mean, cand, cand_mask):
    ei_masked = torch.where(cand_mask, ei_mean, float("-inf"))
    best_cand = torch.argmax(ei_masked)
    return best_cand, ei_masked[best_cand], cand[best_cand]


# ------------------------------------------------- full suggestion steps
def sharded_suggest_obs(mesh: ObsMesh, config, stage_times: dict | None
                        = None):
    """The large-n suggestion: a fully-Bayesian GP-EI step whose n×n
    working set exists only as obs-sharded column slabs (BASELINE config
    5: 10k observations, chains, large EI candidate sets).

    ``engine.suggest.suggest_step``'s semantics, with the JAX version's
    two intentional differences: no pending fantasization (the choosers
    take the chains path when jobs are pending) and no L-BFGS refinement
    (the dense candidate sweep is the optimizer; ``x_opt``/``ei_opt`` are
    the grid argmax).  The chains draw exactly what ``suggest_step`` draws
    from the same generator (``engine/suggest._sample_chains``, chain
    groups included).  The EI phase factors each group of ``chain_chunk``
    samples (all at once when 0) and sweeps the candidates in chunks of
    ``CAND_CHUNK`` through the distributed solves.

    Returns a callable (gen, hypers[chains], x, y, mask, cand, cand_mask)
    → engine.suggest.SuggestResult, the same on every rank.  With
    ``stage_times`` the seconds of the mcmc and ei stages are added to it,
    as ``engine.suggest.suggest_step`` adds them."""
    kernel = config.kernel
    mcfg = _obs_mcmc(mesh, config.mcmc)

    def step(gen, hypers, x, y, mask, cand, cand_mask):
        dev = mesh.device
        (hypers,), (x, y, cand), (mask, cand_mask) = _put_all(
            dev, [hypers], [x, y, cand], [mask, cand_mask])
        clock = trace.StageClock(stage_times, dev)
        with _stage(clock, "mcmc"):
            h_last, flat = _sample_chains(gen, hypers, x, y, mask, config,
                                          mcfg)
        with _stage(clock, "ei"):
            best = torch.where(mask, y, float("inf")).min()
            parts, oks = [], []
            for sl in _groups(flat.mean.shape[0], config.chain_chunk):
                h = _take(flat, sl)
                l_col, alpha, ok = _value_pieces(mesh, x, y, mask, h, kernel)
                parts.append(torch.cat([
                    _ei_chunk(mesh, x, mask, h, l_col, alpha, best, cc,
                              kernel)
                    for cc in _chunk_candidates(cand)], -1))
                oks.append(ok)
                del l_col
            ei_mean, n_ok = nan_robust_mean(torch.cat(parts), torch.cat(oks))
            best_cand, best_ei, x_best = _argmax_result(ei_mean, cand,
                                                        cand_mask)
        clock.close()
        return SuggestResult(
            hypers=h_last, samples=flat, ei=ei_mean, best_cand=best_cand,
            best_cand_ei=best_ei, x_opt=x_best, ei_opt=best_ei, n_ok=n_ok)

    return step


def sharded_suggest_per_sec(mesh: ObsMesh, config,
                            stage_times: dict | None = None):
    """Obs-sharded EI per second (two GPs, large n): both chain families
    sweep with obs-sharded marginals and each EI/sec sample factors both
    families' matrices as slabs.  Same regime and same intentional
    differences as ``sharded_suggest_obs``; the generator is split as
    ``engine.per_sec.suggest_step_per_sec`` splits it (value chains,
    duration chains, and the fantasies' stream, unused here).

    Returns a callable (gen, hypers, time_hypers, x, y, log_durs, mask,
    cand, cand_mask) → engine.per_sec.PerSecResult, the same on every
    rank."""
    kernel = config.kernel
    mcfg = _obs_mcmc(mesh, config.mcmc)

    def step(gen, hypers, time_hypers, x, y, log_durs, mask, cand,
             cand_mask):
        dev = mesh.device
        (hypers, time_hypers), (x, y, log_durs, cand), (mask, cand_mask) = (
            _put_all(dev, [hypers, time_hypers], [x, y, log_durs, cand],
                     [mask, cand_mask]))
        g_val, g_time, _ = split_generator(gen, 3)
        clock = trace.StageClock(stage_times, dev)
        with _stage(clock, "mcmc"):
            h_last, flat = _sample_chains(g_val, hypers, x, y, mask, config,
                                          mcfg)
            t_last, t_flat = _sample_chains(g_time, time_hypers, x, log_durs,
                                            mask, config, mcfg)
        with _stage(clock, "ei"):
            best = torch.where(mask, y, float("inf")).min()
            parts, oks = [], []
            for sl in _groups(flat.mean.shape[0], config.chain_chunk):
                h, th = _take(flat, sl), _take(t_flat, sl)
                l_col, alpha, ok_v = _value_pieces(mesh, x, y, mask, h,
                                                   kernel)
                # only the duration posterior's MEAN is needed: its slab goes
                _, t_alpha, ok_t = _value_pieces(mesh, x, log_durs, mask,
                                                 th, kernel)
                chunks = []
                for cc in _chunk_candidates(cand):
                    ei = _ei_chunk(mesh, x, mask, h, l_col, alpha, best, cc,
                                   kernel)
                    t_mu = th.mean[:, None] + (
                        t_alpha[:, None, :] @ _cross(x, mask, th, cc, kernel)
                    )[:, 0]
                    chunks.append(ei / torch.clamp_min(torch.exp(t_mu),
                                                       MIN_SECONDS))
                parts.append(torch.cat(chunks, -1))
                oks.append(ok_v & ok_t)
                del l_col
            ei_mean, n_ok = nan_robust_mean(torch.cat(parts), torch.cat(oks))
            best_cand, best_ei, x_best = _argmax_result(ei_mean, cand,
                                                        cand_mask)
        clock.close()
        return PerSecResult(
            hypers=h_last, time_hypers=t_last, ei_per_s=ei_mean,
            best_cand=best_cand, best_cand_ei=best_ei, x_opt=x_best,
            ei_opt=best_ei, n_ok=n_ok, samples=flat, time_samples=t_flat)

    return step
