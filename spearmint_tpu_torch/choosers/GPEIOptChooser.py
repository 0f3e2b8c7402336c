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

Band mode (``band_joint_min`` > 0) routes as the JAX chooser does, with
the card in place of the TPU (``band_gate``): on the CPU the chooser runs
dense, as the JAX one does off the TPU.

``profile_dir``: each suggestion's step runs under ``torch.profiler`` and
one Chrome trace per call is written there (``utils/trace``), as the JAX
chooser writes one ``jax.profiler`` trace per call; a trace that lost the
device events of the kernels the call launched raises.  Empty (the
default), the step runs with no profiler and no extra synchronize.

Several ranks (``engine/distributed``): every rank runs the same ``next``
on the same inputs.  From pad ``obs_shard_min``, with no pending jobs and
a rank count that divides the pad, the suggestion runs observation-sharded
over the ranks of the default group (``engine/obs_shard.use_obs_gate``;
the event's ``mode`` is ``obs_shard``), else every rank runs the chains
path alone (``mode`` ``chains``); the burn-in runs unsharded on every
rank, as the JAX chooser's does.  The count is the group's ranks, not the
GPUs a process sees.  Only the coordinator writes the state file, the
events and the traces; the other ranks keep the state in memory, and every
rank waits at a barrier after the write, so a chooser made anew on any
rank reads the same state.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from spearmint_tpu_torch.convert import hypers_from_numpy, hypers_to_numpy
from spearmint_tpu_torch.engine import distributed
from spearmint_tpu_torch.engine.obs_shard import use_obs_gate
from spearmint_tpu_torch.store.locker import Locker
from spearmint_tpu_torch.utils.args import unpack_args
from spearmint_tpu_torch.utils.events import EventLog
from spearmint_tpu_torch.utils.platform import resolve_device


def init(expt_dir, arg_string=""):
    return GPEIOptChooser(expt_dir, **unpack_args(arg_string))


def band_gate(band_joint_min: int, pad: int, use_obs: bool,
              device: torch.device) -> bool:
    """The JAX chooser's band-mode routing (``GPEIOptChooser.py:304-308``):
    a joint move through the per-move band reduction from pad
    ``band_joint_min`` on 128-aligned pads, off the observation-sharded
    path, and on the card only (the JAX one: on the TPU only)."""
    return (band_joint_min > 0 and pad >= band_joint_min and pad % 128 == 0
            and not use_obs and device.type == "cuda")


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
        band_joint_min=0,      # pad from which the joint move runs in
                               # band mode (ops/band, kernel B5); 0: off
        device="cuda",
    ):
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
        self.band_joint_min = int(band_joint_min)
        self.seed = int(seed)
        self.optimize = True  # GPEIChooser flips this off
        self.profile_dir = str(profile_dir)  # a trace per call when set
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
        """The coordinator writes; with several ranks, all wait for it."""
        if distributed.is_coordinator():
            with self.locker:
                tmp = self.state_file + ".tmp.npz"
                np.savez(tmp, **self._state_arrays(),
                         key_state=self._key_state,
                         burned_in=self._burned_in)
                os.replace(tmp, self.state_file)
        if distributed.world_size() > 1:
            torch.distributed.barrier()

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

    def _pad_pending_and_candidates(self, grid, pending, candidates, pad):
        """Pending points at ``pend_pad(pad, P)`` and candidates at their
        bucket (at least 64), each with its mask."""
        from spearmint_tpu_torch.core.linalg import pad_bucket, pend_pad

        ndim = grid.shape[1]
        pend = grid[pending].astype(np.float32)
        p = pend.shape[0]
        ppad = pend_pad(pad, p)
        pend_p = np.zeros((ppad, ndim), np.float32)
        pend_p[:p] = pend
        cand = grid[candidates].astype(np.float32)
        c = cand.shape[0]
        cpad = pad_bucket(c, minimum=64)
        cand_p = np.zeros((cpad, ndim), np.float32)
        cand_p[:c] = cand
        return pend_p, np.arange(ppad) < p, cand_p, np.arange(cpad) < c

    def _use_obs(self, pad, n_pending) -> bool:
        """The obs-sharded route: ``use_obs_gate`` over the default
        group's ranks."""
        return use_obs_gate(self.obs_shard_min, distributed.world_size(),
                            pad, n_pending)

    def _obs_step(self, cfg, factory="sharded_suggest_obs"):
        """The obs-sharded step over every rank of the default group
        (``factory``: the per-sec chooser's ``sharded_suggest_per_sec``)."""
        from spearmint_tpu_torch.engine import obs_shard

        return getattr(obs_shard, factory)(
            obs_shard.make_obs_mesh(device=self.device), cfg)

    def _choose(self, candidates, best_cand, best_value, x_opt, opt_value):
        """The refined point as an ``(value, x)`` invention if it beats the
        best candidate's value, else that candidate's grid index."""
        x_opt = x_opt.detach().cpu().numpy().astype(np.float64)
        opt_value = float(opt_value)
        if (self.optimize and opt_value > float(best_value)
                and np.all(np.isfinite(x_opt))):
            return opt_value, x_opt
        return int(candidates[int(best_cand)])

    def _timed_step(self, step):
        """``step()`` and its seconds up to a device synchronize (the event
        log's latency).  With ``profile_dir``, on the coordinator, under
        ``torch.profiler``: one trace per call."""
        if self.profile_dir and distributed.is_coordinator():
            return self._profiled_step(step)
        t0 = time.perf_counter()
        res = step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return res, time.perf_counter() - t0

    def _profiled_step(self, step):
        """``_timed_step`` under ``torch.profiler`` (the CPU, and the card
        when the step runs there).  On the card the session idles
        ``trace.MARGIN_S`` and launches ``trace.lead_in`` before the step,
        and idles again after its synchronize, so that neither early
        device timestamps nor the loss of a session's first records can
        take the step's own (``utils/trace``).  Writes
        ``<chooser>.<key_state>.<pid>.pt.trace.json`` into ``profile_dir``
        and raises if the trace lost the device events of the kernels the
        step launched (the trace is then renamed ``*.incomplete``)."""
        from torch.profiler import ProfilerActivity, profile

        from spearmint_tpu_torch.utils import trace

        dev = self.device
        on_card = dev.type == "cuda"
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        before = trace.kernel_launches()
        with profile(activities=acts) as prof:
            if on_card:
                time.sleep(trace.MARGIN_S)
                trace.lead_in(dev)
            t0 = time.perf_counter()
            res = step()
            if on_card:
                torch.cuda.synchronize(dev)
            latency = time.perf_counter() - t0
            if on_card:
                time.sleep(trace.MARGIN_S)
        launched = {k: n - before[k]
                    for k, n in trace.kernel_launches().items()}
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(
            self.profile_dir, f"{type(self).__name__}.{self._key_state}."
                              f"{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        try:
            trace.check(path, launched, with_lead_in=on_card)
        except RuntimeError:
            os.replace(path, path + ".incomplete")
            raise
        return res, latency

    def _emit(self, kind, **fields):
        """An event of the coordinator: one line a suggestion, however
        many ranks run it."""
        if distributed.is_coordinator():
            self.events.emit(kind, **fields)

    def _emit_suggest(self, latency, n_obs, n_pending, n_cand, **extra):
        self._emit(
            "suggest", chooser=type(self).__name__,
            latency_s=round(latency, 4), n_obs=int(n_obs),
            n_pending=int(n_pending), n_cand=int(n_cand), **extra)

    # ------------------------------------------------------ the protocol
    def next(self, grid, values, durations, candidates, pending, complete):
        # Fewer than 2 completions: take the next grid candidate.
        if len(complete) < 2:
            return int(candidates[0])

        from spearmint_tpu_torch.core.linalg import pad_bucket
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

        pend_p, pend_mask, cand_p, cand_mask = (
            self._pad_pending_and_candidates(grid, pending, candidates, pad))
        p, c = len(pending), len(candidates)
        use_obs = self._use_obs(pad, p)

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
            band_joint=band_gate(self.band_joint_min, pad, use_obs, dev),
        )
        if use_obs:
            res, latency = self._timed_step(lambda: self._obs_step(cfg)(
                gen, self._hypers, xt, yt, mt, cand_p, cand_mask))
        else:
            res, latency = self._timed_step(lambda: suggest_step(
                gen, self._hypers, xt, yt, mt, pend_p, pend_mask, cand_p,
                cand_mask, cfg, device=dev))
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
            mode="obs_shard" if use_obs else "chains", n_ok=n_ok,
            device=str(dev),
            band_joint=cfg.band_joint,
        )
        if n_ok == 0:
            # every sample's factorization failed: the averaged EI carries
            # no signal — fall back to grid order and say so
            self._emit("suggest_degenerate",
                       chooser=type(self).__name__, n_obs=int(n))
            return int(candidates[0])

        return self._choose(candidates, res.best_cand, res.best_cand_ei,
                            res.x_opt, res.ei_opt)
