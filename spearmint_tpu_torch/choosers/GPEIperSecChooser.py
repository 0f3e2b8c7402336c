"""Cost-aware GP chooser: expected improvement per second.

JAX counterpart: ``spearmint_tpu/choosers/GPEIperSecChooser.py``.  The
flagship's host duties (padding, memory policy, burn-in, events, the
degenerate-sample fallback, the tuple protocol) with a second GP over the
log job durations; the numerics run in
``engine.per_sec.suggest_step_per_sec`` on ``device``.  Durations are
clamped as the JAX chooser clamps them: a missing one counts as 1 s, and
none below 1 ms.

Three deliberate differences from the JAX chooser, all reference defects:
  * non-finite objective values are dropped with their durations and
    inputs, as the flagship drops them (the JAX chooser keeps them, and
    one NaN completion makes every later suggestion degenerate);
  * after a suggestion whose samples all failed (n_ok == 0) the chain
    states of both families are kept as they were; the key still
    advances;
  * ``profile_dir`` traces each call as the flagship's does (the JAX
    chooser takes the option and ignores it: its ``next`` never enters a
    trace).

The state file and its npz keys are the JAX chooser's
(``GPEIperSecChooser_state.npz``: the flagship's keys plus ``time_mean,
time_amp2, time_noise, time_ls``), so an experiment written by either
package resumes under the other.  With several ranks the suggestion
routes as the flagship's does (``engine/obs_shard.sharded_suggest_per_sec``
from pad ``obs_shard_min`` with no pending jobs), and only the coordinator
writes the state and the events.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from spearmint_tpu_torch.choosers.GPEIOptChooser import GPEIOptChooser
from spearmint_tpu_torch.convert import hypers_from_numpy, hypers_to_numpy
from spearmint_tpu_torch.utils.args import unpack_args

_TIME = "time_"


def init(expt_dir, arg_string=""):
    return GPEIperSecChooser(expt_dir, **unpack_args(arg_string))


def log_durations(durations) -> np.ndarray:
    """The JAX chooser's clamp: NaN → 1 s, floor 1 ms, then log."""
    durs = np.asarray(durations, dtype=np.float64)
    return np.log(np.maximum(np.nan_to_num(durs, nan=1.0),
                             1e-3)).astype(np.float32)


class GPEIperSecChooser(GPEIOptChooser):
    def __init__(self, expt_dir, **kwargs):
        super().__init__(expt_dir, **kwargs)
        self._time_hypers = None   # GPHypers of the duration GP

    # ------------------------------------------------------ state io
    def _read_state(self, z):
        super()._read_state(z)
        if _TIME + "ls" in z.files:
            self._time_hypers = hypers_from_numpy(z, self.device, _TIME)

    def _state_arrays(self) -> dict:
        return {**super()._state_arrays(),
                **hypers_to_numpy(self._time_hypers, _TIME)}

    # ------------------------------------------------------ the protocol
    def next(self, grid, values, durations, candidates, pending, complete):
        if len(complete) < 2:
            return int(candidates[0])

        from spearmint_tpu_torch.core.linalg import pad_bucket
        from spearmint_tpu_torch.engine.per_sec import suggest_step_per_sec
        from spearmint_tpu_torch.engine.suggest import (
            SuggestConfig, init_chain_states,
        )

        t_call, burn_s = time.perf_counter(), 0.0
        grid = np.asarray(grid)
        ndim = grid.shape[1]
        comp = grid[complete].astype(np.float32)
        vals = np.asarray(values)[complete].astype(np.float32)
        durs = np.asarray(durations)[complete]
        # NaN objectives carry no value to model: drop them with their
        # durations (the JAX chooser keeps them, a reference defect)
        finite = np.isfinite(vals)
        if not np.all(finite):
            comp, vals, durs = comp[finite], vals[finite], durs[finite]
            if comp.shape[0] < 2:
                return int(candidates[0])
        log_durs = log_durations(durs)

        n = comp.shape[0]
        pad = pad_bucket(n)
        xp = np.zeros((pad, ndim), np.float32); xp[:n] = comp
        yp = np.zeros(pad, np.float32); yp[:n] = vals
        tp = np.zeros(pad, np.float32); tp[:n] = log_durs
        mask = np.arange(pad) < n

        pend_p, pend_mask, cand_p, cand_mask = (
            self._pad_pending_and_candidates(grid, pending, candidates, pad))
        p, c = len(pending), len(candidates)
        use_obs = self._use_obs(pad, p)

        dev = self.device
        xt = torch.as_tensor(xp, device=dev)
        yt = torch.as_tensor(yp, device=dev)
        tt = torch.as_tensor(tp, device=dev)
        mt = torch.as_tensor(mask, device=dev)

        self._load_state(ndim)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self._key_state)
        if self._hypers is None:
            self._hypers = init_chain_states(yt, mt, ndim, self.chains)
        if self._time_hypers is None:
            self._time_hypers = init_chain_states(tt, mt, ndim, self.chains)
        if not self._burned_in and self.burnin_steps > 0:
            # the reference's _real_init burn-in, for both families
            t_burn = time.perf_counter()
            self._hypers = self._burn_chains(gen, self._hypers, xt, yt, mt)
            self._time_hypers = self._burn_chains(gen, self._time_hypers,
                                                  xt, tt, mt)
            self._burned_in = True
            burn_s = time.perf_counter() - t_burn

        # mcmc_iters = samples per suggestion, spread across the chains
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
        prepare_s = time.perf_counter() - t_call - burn_s
        if use_obs:
            res, latency, step_fields = self._timed_step(
                lambda st: self._obs_step(cfg, st, "sharded_suggest_per_sec")(
                    gen, self._hypers, self._time_hypers, xt, yt, tt, mt,
                    cand_p, cand_mask))
        else:
            res, latency, step_fields = self._timed_step(
                lambda st: suggest_step_per_sec(
                    gen, self._hypers, self._time_hypers, xt, yt, tt, mt,
                    pend_p, pend_mask, cand_p, cand_mask, cfg, device=dev,
                    stage_times=st))
        n_ok = int(res.n_ok)
        # Unlike the JAX chooser, a sweep in which every sample failed
        # replaces neither chain family; the key still advances.
        if n_ok > 0:
            self._hypers = res.hypers
            self._time_hypers = res.time_hypers
        self._key_state += 1
        host_s = self._timed_save(prepare_s)
        self._emit_suggest(
            latency, n, p, c, host_s=host_s, **step_fields,
            ei_best=float(res.best_cand_ei), ei_opt=float(res.ei_opt),
            time_amp2_med=float(res.time_hypers.amp2.median()),
            mode="obs_shard" if use_obs else "chains",
            chain_chunk=chain_chunk, n_ok=n_ok,
            device=str(dev),
        )
        if n_ok == 0:
            # every sample's factorization failed: the average carries no
            # signal — fall back to grid order and say so
            self._emit("suggest_degenerate",
                       chooser=type(self).__name__, n_obs=int(n))
            return int(candidates[0])

        return self._choose(candidates, res.best_cand, res.best_cand_ei,
                            res.x_opt, res.ei_opt)
