"""Constrained GP-EI chooser.

JAX counterpart: ``spearmint_tpu/choosers/GPConstrainedEIChooser.py``.
Observations whose objective came back NaN are constraint violations; a
latent probit GP classifies feasibility and weights EI
(``engine.constrained.suggest_step_constrained``, on ``device``).  Host
duties as in the flagship: padding, memory policy, burn-in of both chain
families on first init, events, the degenerate-sample fallback and the
tuple protocol.  One deliberate difference, as in the port's flagship:
after a suggestion whose samples all failed (n_ok == 0) the value and
constraint chain states are kept as they were; the key still advances.

The state file and its npz keys are the JAX chooser's
(``GPConstrainedEIChooser_state.npz``: the flagship's keys plus
``c_ls, c_amp2, c_ff``), so an experiment written by either package
resumes under the other.  When the observation bucket changes, the latent
vectors are re-padded keeping their aligned prefix.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from spearmint_tpu_torch.choosers.GPEIOptChooser import GPEIOptChooser
from spearmint_tpu_torch.convert import (
    constraint_from_numpy, constraint_to_numpy,
)
from spearmint_tpu_torch.utils.args import unpack_args


def init(expt_dir, arg_string=""):
    return GPConstrainedEIChooser(expt_dir, **unpack_args(arg_string))


class GPConstrainedEIChooser(GPEIOptChooser):
    def __init__(self, expt_dir, **kwargs):
        super().__init__(expt_dir, **kwargs)
        self._constraint = None   # ConstraintState, leading chains axis

    # ------------------------------------------------------ state io
    def _read_state(self, z):
        super()._read_state(z)
        if "c_ls" in z.files:
            self._constraint = constraint_from_numpy(z, self.device)

    def _state_arrays(self) -> dict:
        return {**super()._state_arrays(),
                **constraint_to_numpy(self._constraint)}

    # ------------------------------------------------------ the protocol
    def next(self, grid, values, durations, candidates, pending, complete):
        if len(complete) < 2:
            return int(candidates[0])

        from spearmint_tpu_torch.core.linalg import pad_bucket
        from spearmint_tpu_torch.engine.constrained import (
            burnin_constraint_states, init_constraint_states,
            suggest_step_constrained,
        )
        from spearmint_tpu_torch.engine.suggest import (
            SuggestConfig, init_chain_states,
        )

        grid = np.asarray(grid)
        ndim = grid.shape[1]
        comp = grid[complete].astype(np.float32)
        vals_raw = np.asarray(values)[complete].astype(np.float64)
        valid = np.isfinite(vals_raw)
        if valid.sum() < 2:
            # nothing feasible yet: keep exploring the grid
            return int(candidates[0])
        vals = np.where(valid, vals_raw, 0.0).astype(np.float32)
        cand = grid[candidates].astype(np.float32)

        n = comp.shape[0]
        pad = pad_bucket(n)
        xp = np.zeros((pad, ndim), np.float32); xp[:n] = comp
        yp = np.zeros(pad, np.float32); yp[:n] = vals
        obs_mask = np.arange(pad) < n
        valid_mask = np.zeros(pad, bool); valid_mask[:n] = valid

        c = cand.shape[0]
        cpad = pad_bucket(c, minimum=64)
        cand_p = np.zeros((cpad, ndim), np.float32); cand_p[:c] = cand
        cand_mask = np.arange(cpad) < c

        dev = self.device
        xt = torch.as_tensor(xp, device=dev)
        yt = torch.as_tensor(yp, device=dev)
        vm = torch.as_tensor(valid_mask, device=dev)
        om = torch.as_tensor(obs_mask, device=dev)
        zt = torch.where(vm, 1.0, -1.0)

        self._load_state(ndim)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self._key_state)
        if self._hypers is None:
            self._hypers = init_chain_states(yt, vm, ndim, self.chains)
        if self._constraint is None:
            self._constraint = init_constraint_states(ndim, pad, self.chains,
                                                      device=dev)
        elif self._constraint.ff.shape[1] != pad:
            # observation bucket changed: re-pad the latent vectors, keeping
            # the aligned prefix (latents follow observation order)
            ff_old = self._constraint.ff
            ff = torch.zeros((self.chains, pad), dtype=ff_old.dtype,
                             device=dev)
            keep = min(pad, ff_old.shape[1])
            ff[:, :keep] = ff_old[:, :keep]
            self._constraint = self._constraint._replace(ff=ff)
        if not self._burned_in and self.burnin_steps > 0:
            self._hypers = self._burn_chains(gen, self._hypers, xt, yt, vm)
            self._constraint = burnin_constraint_states(
                gen, self._constraint, xt, zt, om, self.burnin_steps)
            self._burned_in = True

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
            chain_chunk=chain_chunk,
            explicit_inverse=explicit_inv,
        )
        t0 = time.perf_counter()
        res = suggest_step_constrained(
            gen, self._hypers, self._constraint, xt, yt, vm, om, cand_p,
            cand_mask, cfg, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        latency = time.perf_counter() - t0
        n_ok = int(res.n_ok)
        # Unlike the JAX chooser, a sweep in which every sample failed
        # replaces neither chain family: a stuck state would carry over to
        # the next call.  The key still advances.
        if n_ok > 0:
            self._hypers = res.hypers
            self._constraint = res.constraint
        self._key_state += 1
        self._save_state()
        self._emit_suggest(
            latency, n, 0, c,
            acq_best=float(res.best_cand_acq), acq_opt=float(res.acq_opt),
            n_valid=int(valid.sum()),
            c_amp2_med=float(res.constraint.amp2.median()),
            mode="chains", chain_chunk=chain_chunk, n_ok=n_ok,
            device=str(dev),
        )
        if n_ok == 0:
            # every sample's factorization failed: the average carries no
            # signal — fall back to grid order and say so
            self.events.emit("suggest_degenerate",
                             chooser=type(self).__name__, n_obs=int(n))
            return int(candidates[0])

        acq_opt = float(res.acq_opt)
        best_cand_acq = float(res.best_cand_acq)
        x_opt = res.x_opt.detach().cpu().numpy().astype(np.float64)
        if self.optimize and acq_opt > best_cand_acq and np.all(
                np.isfinite(x_opt)):
            return float(acq_opt), x_opt
        return int(candidates[int(res.best_cand)])
