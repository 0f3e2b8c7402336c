"""GP-EI chooser with off-grid EI optimization — the flagship.

JAX counterpart: ``spearmint_tpu/choosers/GPEIOptChooser.py``.  Same
protocol (``next(grid, values, durations, candidates, pending, complete)``
returns a grid index or an ``(ei, point)`` off-grid invention), padding,
memory policy, burn-in, events, degenerate-sample fallback and finite-value
filter; the numerics run in ``engine.suggest.suggest_step`` on ``device``.
One deliberate difference: after a suggestion whose samples all failed
(n_ok == 0) the chain states are kept as they were, not saved.

The state file and its npz keys are the JAX chooser's
(``GPEIOptChooser_state.npz``: mean, amp2, noise, ls, key_state,
burned_in), so an experiment written by either package resumes under the
other.  The random streams differ (``torch.Generator`` seeded with
``key_state`` here, ``jax.random.PRNGKey`` there).

Not ported yet, and refused with NotImplementedError: band mode
(``band_joint_min`` ≠ 0, ROADMAP A11), ``profile_dir`` (ROADMAP A6) and
the observation-sharded path across several GPUs (ROADMAP A10).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from spearmint_tpu_torch.convert import hypers_from_numpy, hypers_to_numpy
from spearmint_tpu_torch.store.locker import Locker
from spearmint_tpu_torch.utils.args import unpack_args
from spearmint_tpu_torch.utils.events import EventLog
from spearmint_tpu_torch.utils.platform import resolve_device


def init(expt_dir, arg_string=""):
    return GPEIOptChooser(expt_dir, **unpack_args(arg_string))


def use_obs_gate(obs_shard_min: int, ndev: int, pad: int,
                 n_pending: int) -> bool:
    """The JAX package's obs-mesh routing decision
    (``engine/obs_shard.use_obs_gate``), kept to refuse what it routes."""
    return (obs_shard_min > 0 and ndev > 1 and pad >= obs_shard_min
            and pad % ndev == 0 and n_pending == 0)


class GPEIOptChooser:
    def __init__(
        self,
        expt_dir,
        covar="Matern52",
        mcmc_iters=10,
        pending_samples=100,
        noiseless=0,
        burnin=100,
        grid_subset=20,
        chains=10,
        lbfgs_iters=50,
        max_obs_pad=None,
        seed=0,
        profile_dir="",
        obs_shard_min=8192,
        chain_chunk=-1,        # -1: auto memory policy; 0: one batch
        explicit_inverse=-1,   # -1: auto (off at large pad); 0/1 force
        band_joint_min=0,
        device="cuda",
    ):
        if int(band_joint_min) != 0:
            raise NotImplementedError(
                "band_joint_min: band mode (ops/band) is not ported yet — "
                "ROADMAP A11")
        if str(profile_dir):
            raise NotImplementedError(
                "profile_dir: profiling is not ported yet — ROADMAP A6")
        self.device = resolve_device(device)
        self.expt_dir = expt_dir
        self.covar = str(covar)
        self.mcmc_iters = int(mcmc_iters)
        self.pending_samples = int(pending_samples)
        self.noiseless = bool(int(noiseless))
        self.burnin_steps = int(burnin)
        self.grid_subset = int(grid_subset)
        self.chains = int(chains)
        self.lbfgs_iters = int(lbfgs_iters)
        self.max_obs_pad = max_obs_pad
        self.obs_shard_min = int(obs_shard_min)
        self.chain_chunk = int(chain_chunk)
        self.explicit_inverse = int(explicit_inverse)
        self.seed = int(seed)
        self.optimize = True  # GPEIChooser flips this off
        self.state_file = os.path.join(
            expt_dir, f"{type(self).__name__}_state.npz")
        self.locker = Locker(self.state_file)
        self.events = EventLog(expt_dir)
        self._hypers = None     # GPHypers, leading chains axis
        self._burned_in = False

    # ------------------------------------------------------ state io
    def _load_state(self, ndim):
        if self._hypers is not None:
            return
        with self.locker:
            if os.path.exists(self.state_file):
                with np.load(self.state_file) as z:
                    if z["ls"].shape == (self.chains, ndim):
                        self._read_state(z)
                        self._key_state = int(z["key_state"])
                        self._burned_in = bool(z["burned_in"])
                        return
        self._key_state = self.seed
        self._burned_in = False

    def _read_state(self, z):
        """The chain states of an npz whose shapes fit (subclasses add)."""
        self._hypers = hypers_from_numpy(z, self.device)

    def _state_arrays(self) -> dict:
        return hypers_to_numpy(self._hypers)

    def _save_state(self):
        with self.locker:
            tmp = self.state_file + ".tmp.npz"
            np.savez(tmp, **self._state_arrays(),
                     key_state=self._key_state, burned_in=self._burned_in)
            os.replace(tmp, self.state_file)

    # ------------------------------------------------------ shared helpers
    def _memory_policy(self, pad):
        """Resolve (chain_chunk, explicit_inverse) for this bucket size:
        bound the live [chunk, pad, pad] f32 buffers at ~2.5 GB (two per
        in-flight chain: the assembled M and the factorization workspace),
        and stop materializing L⁻¹ from pad 8192."""
        chunk = self.chain_chunk
        if chunk < 0:
            per_chain = 2 * 4.0 * pad * pad
            c = int(min(self.chains, max(1, 2.5e9 // per_chain)))
            if c >= self.chains:
                chunk = 0
            else:
                while self.chains % c:
                    c -= 1
                chunk = c
        inv = self.explicit_inverse
        if inv < 0:
            inv = pad < 8192
        return chunk, bool(inv)

    def _burn_chains(self, gen, hypers, x, y, mask):
        """Reference _real_init: ``burnin`` fresh-marginal sweeps of every
        chain before the first suggestion."""
        from spearmint_tpu_torch.mcmc.chains import MCMCConfig, sample_hypers

        mcfg = MCMCConfig(noiseless=self.noiseless)
        for _ in range(self.burnin_steps):
            hypers = sample_hypers(gen, hypers, x, y, mask, mcfg)
        return hypers

    def _emit_suggest(self, latency, n_obs, n_pending, n_cand, **extra):
        self.events.emit(
            "suggest", chooser=type(self).__name__,
            latency_s=round(latency, 4), n_obs=int(n_obs),
            n_pending=int(n_pending), n_cand=int(n_cand), **extra)

    # ------------------------------------------------------ the protocol
    def next(self, grid, values, durations, candidates, pending, complete):
        # Fewer than 2 completions: take the next grid candidate.
        if len(complete) < 2:
            return int(candidates[0])

        from spearmint_tpu_torch.core.linalg import pad_bucket, pend_pad
        from spearmint_tpu_torch.engine.suggest import (
            SuggestConfig, init_chain_states, suggest_step,
        )

        grid = np.asarray(grid)
        ndim = grid.shape[1]
        comp = grid[complete].astype(np.float32)
        vals = np.asarray(values)[complete].astype(np.float32)
        # NaN objectives are constraint violations; drop them here
        finite = np.isfinite(vals)
        if not np.all(finite):
            comp, vals = comp[finite], vals[finite]
            if comp.shape[0] < 2:
                return int(candidates[0])
        pend = grid[pending].astype(np.float32)
        cand = grid[candidates].astype(np.float32)

        n = comp.shape[0]
        pad = pad_bucket(n)
        if self.max_obs_pad:
            pad = min(pad, int(self.max_obs_pad))
            if n > pad:
                comp, vals = comp[-pad:], vals[-pad:]
                n = pad
        xp = np.zeros((pad, ndim), np.float32); xp[:n] = comp
        yp = np.zeros(pad, np.float32); yp[:n] = vals
        mask = np.arange(pad) < n

        p = pend.shape[0]
        ppad = pend_pad(pad, p)
        pend_p = np.zeros((ppad, ndim), np.float32)
        pend_p[:p] = pend
        pend_mask = np.arange(ppad) < p

        c = cand.shape[0]
        cpad = pad_bucket(c, minimum=64)
        cand_p = np.zeros((cpad, ndim), np.float32)
        cand_p[:c] = cand
        cand_mask = np.arange(cpad) < c

        ndev = (torch.cuda.device_count() if self.device.type == "cuda"
                else 1)
        if use_obs_gate(self.obs_shard_min, ndev, pad, p):
            raise NotImplementedError(
                f"pad {pad} on {ndev} GPUs routes to the observation-"
                "sharded path, which is not ported yet — ROADMAP A10")

        dev = self.device
        xt = torch.as_tensor(xp, device=dev)
        yt = torch.as_tensor(yp, device=dev)
        mt = torch.as_tensor(mask, device=dev)

        self._load_state(ndim)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self._key_state)
        if self._hypers is None:
            self._hypers = init_chain_states(yt, mt, ndim, self.chains)
        if not self._burned_in and self.burnin_steps > 0:
            self._hypers = self._burn_chains(gen, self._hypers, xt, yt, mt)
            self._burned_in = True

        # mcmc_iters = samples PER SUGGESTION, spread across the chains
        iters_per_chain = max(1, -(-self.mcmc_iters // self.chains))
        chain_chunk, explicit_inv = self._memory_policy(pad)
        cfg = SuggestConfig(
            mcmc_iters=iters_per_chain,
            noiseless=self.noiseless,
            kernel_name=self.covar,
            grid_subset=self.grid_subset,
            lbfgs_iters=self.lbfgs_iters,
            optimize=self.optimize,
            has_pending=p > 0,
            n_fantasies=self.pending_samples,
            chain_chunk=chain_chunk,
            explicit_inverse=explicit_inv,
        )
        t0 = time.perf_counter()
        res = suggest_step(gen, self._hypers, xt, yt, mt, pend_p, pend_mask,
                           cand_p, cand_mask, cfg, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        latency = time.perf_counter() - t0
        n_ok = int(res.n_ok)
        # Unlike the JAX chooser, a sweep in which every sample failed
        # does not replace the chain states: a stuck state would carry
        # over to the next call.  The key still advances.
        if n_ok > 0:
            self._hypers = res.hypers
        self._key_state += 1
        self._save_state()
        self._emit_suggest(
            latency, n, p, c,
            ei_best=float(res.best_cand_ei), ei_opt=float(res.ei_opt),
            amp2_med=float(res.hypers.amp2.median()),
            noise_med=float(res.hypers.noise.median()),
            mode="chains", n_ok=n_ok, device=str(dev),
        )
        if n_ok == 0:
            # every sample's factorization failed: the averaged EI carries
            # no signal — fall back to grid order and say so
            self.events.emit("suggest_degenerate",
                             chooser=type(self).__name__, n_obs=int(n))
            return int(candidates[0])

        best_cand_ei = float(res.best_cand_ei)
        ei_opt = float(res.ei_opt)
        x_opt = res.x_opt.detach().cpu().numpy().astype(np.float64)
        # take the optimized point only if it beats the best grid EI
        if (self.optimize and ei_opt > best_cand_ei
                and np.all(np.isfinite(x_opt))):
            return float(ei_opt), x_opt
        return int(candidates[int(res.best_cand)])
