"""Experiment state store: the Sobol candidate grid + per-point status.

JAX counterpart: ``spearmint_tpu/store/experiment.py``, of which this is a
copy on the port's own codec, locker and Sobol grid.  The on-disk format
(``expt-grid.npz`` + ``expt-grid.json``, the same arrays, dtypes and keys)
is the JAX package's, so an experiment resumes under either package.

Parity: reference ``ExperimentGrid.py`` (SURVEY.md §2 #2) — per-point
status ∈ {candidate, submitted, running, complete, broken}, values and
durations, unit-hypercube ↔ typed-parameter mapping, ``add_to_grid`` for
chooser-invented off-grid points, and classmethod-style status flips used
by the runner process.  Differences: state persists as npz+json under an
fcntl lock (vs pickle + procmail lockfile), and every mutation is an
atomic read-modify-write so the async main loop and N runners can race
safely (SURVEY.md §5.2).

The whole store *is* the checkpoint: kill any process at any time and a
restart resumes exactly (SURVEY.md §5.4).
"""

from __future__ import annotations

import json
import os

import numpy as np

from spearmint_tpu_torch.store.codec import ExperimentConfig, Parameter
from spearmint_tpu_torch.store.locker import Locker
from spearmint_tpu_torch.store.sobol import sobol_grid

CANDIDATE_STATE = 0
SUBMITTED_STATE = 1
RUNNING_STATE = 2
COMPLETE_STATE = 3
BROKEN_STATE = 4

STATE_NAMES = ["candidate", "submitted", "running", "complete", "broken"]

_GRID_FILE = "expt-grid.npz"
_META_FILE = "expt-grid.json"


class ExperimentGrid:
    """File-backed experiment grid; every public method round-trips disk
    under the lock, so instances are cheap, disposable views (the
    reference reconstructs its grid every poll the same way)."""

    def __init__(
        self,
        expt_dir: str,
        variables: list | None = None,
        grid_size: int | None = None,
        grid_seed: int = 1,
    ):
        self.expt_dir = str(expt_dir)
        self.locker = Locker(os.path.join(self.expt_dir, _GRID_FILE))
        with self.locker:
            if self._exists():
                self._load()
            else:
                if variables is None or grid_size is None:
                    raise ValueError(
                        f"no grid at {expt_dir} and no variables/grid_size "
                        "to create one"
                    )
                self.variables = [_as_variable_dict(v) for v in variables]
                self.num_dims = sum(v["size"] for v in self.variables)
                self.grid_seed = int(grid_seed)
                base = sobol_grid(self.num_dims, int(grid_size), self.grid_seed)
                self.grid = np.asarray(base, dtype=np.float64)
                n = self.grid.shape[0]
                self.status = np.full(n, CANDIDATE_STATE, dtype=np.int8)
                self.values = np.full(n, np.nan)
                self.durs = np.full(n, np.nan)
                self.proc_ids = np.full(n, -1, dtype=np.int64)
                self.retries = np.zeros(n, dtype=np.int32)
                self._save()

    # ------------------------------------------------------- persistence
    def _npz_path(self):
        return os.path.join(self.expt_dir, _GRID_FILE)

    def _meta_path(self):
        return os.path.join(self.expt_dir, _META_FILE)

    def _exists(self):
        return os.path.exists(self._npz_path())

    def _load(self):
        with np.load(self._npz_path()) as z:
            self.grid = z["grid"]
            self.status = z["status"]
            self.values = z["values"]
            self.durs = z["durs"]
            self.proc_ids = z["proc_ids"]
            self.retries = (z["retries"] if "retries" in z
                            else np.zeros(len(self.status), dtype=np.int32))
        with open(self._meta_path()) as f:
            meta = json.load(f)
        self.variables = meta["variables"]
        self.num_dims = meta["num_dims"]
        self.grid_seed = meta["grid_seed"]

    def _save(self):
        os.makedirs(self.expt_dir, exist_ok=True)
        tmp = self._npz_path() + ".tmp.npz"
        np.savez(tmp, grid=self.grid, status=self.status, values=self.values,
                 durs=self.durs, proc_ids=self.proc_ids,
                 retries=self.retries)
        os.replace(tmp, self._npz_path())
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"variables": self.variables, "num_dims": self.num_dims,
                       "grid_seed": self.grid_seed}, f)
        os.replace(tmp, self._meta_path())

    def _mutate(self, fn):
        """Atomic read-modify-write under the lock."""
        with self.locker:
            self._load()
            out = fn()
            self._save()
        return out

    # ------------------------------------------------------------ queries
    def get_grid(self):
        """(grid, values, durations) — the chooser.next() inputs."""
        return self.grid, self.values, self.durs

    def _where(self, state):
        return np.nonzero(self.status == state)[0]

    def get_candidates(self):
        return self._where(CANDIDATE_STATE)

    def get_submitted(self):
        return self._where(SUBMITTED_STATE)

    def get_running(self):
        return self._where(RUNNING_STATE)

    def get_pending(self):
        return np.nonzero(
            (self.status == SUBMITTED_STATE) | (self.status == RUNNING_STATE)
        )[0]

    def get_complete(self):
        return self._where(COMPLETE_STATE)

    def get_broken(self):
        return self._where(BROKEN_STATE)

    def get_proc_id(self, job_id: int) -> int:
        return int(self.proc_ids[job_id])

    def get_best(self):
        """(best_value, best_index) over complete jobs; (nan, -1) if none.

        NaN values (constraint violations, see GPConstrainedEIChooser)
        are never the best."""
        complete = self.get_complete()
        if len(complete) == 0:
            return np.nan, -1
        vals = self.values[complete]
        if not np.any(np.isfinite(vals)):
            return np.nan, -1
        i = int(np.nanargmin(vals))
        return float(vals[i]), int(complete[i])

    # --------------------------------------------- unit coords ↔ params
    def get_params(self, index: int) -> list[Parameter]:
        """Decode grid row ``index`` into typed parameters (reference
        ``get_params`` ≈L120: INT rounds, FLOAT scales, ENUM indexes)."""
        point = self.grid[index]
        params = []
        offset = 0
        for v in self.variables:
            coords = point[offset:offset + v["size"]]
            offset += v["size"]
            p = Parameter(name=v["name"])
            if v["type"] == "INT":
                p.int_val = [
                    int(v["min"] + np.round(c * (v["max"] - v["min"])))
                    for c in coords
                ]
            elif v["type"] == "FLOAT":
                p.dbl_val = [
                    float(v["min"] + c * (v["max"] - v["min"])) for c in coords
                ]
            elif v["type"] == "ENUM":
                opts = v["options"]
                p.str_val = [
                    opts[min(int(c * len(opts)), len(opts) - 1)] for c in coords
                ]
            else:
                raise ValueError(f"bad variable type {v['type']}")
            params.append(p)
        return params

    def unit_to_list(self, index: int):
        """Flat python values for logging/results files."""
        out = []
        for p in self.get_params(index):
            out.extend(p.int_val or p.dbl_val or p.str_val)
        return out

    # ------------------------------------------------------------ updates
    def add_to_grid(self, candidate: np.ndarray) -> int:
        """Append a chooser-invented off-grid point; returns its index."""
        candidate = np.asarray(candidate, dtype=np.float64).reshape(-1)
        if candidate.shape[0] != self.num_dims:
            raise ValueError("candidate dimensionality mismatch")

        def fn():
            self.grid = np.vstack([self.grid, candidate[None]])
            self.status = np.append(self.status, np.int8(CANDIDATE_STATE))
            self.values = np.append(self.values, np.nan)
            self.durs = np.append(self.durs, np.nan)
            self.proc_ids = np.append(self.proc_ids, -1)
            self.retries = np.append(self.retries, np.int32(0))
            return self.grid.shape[0] - 1

        return self._mutate(fn)

    def _set_state(self, job_id, state, value=None, duration=None,
                   proc_id=None):
        def fn():
            self.status[job_id] = state
            if value is not None:
                self.values[job_id] = value
            if duration is not None:
                self.durs[job_id] = duration
            if proc_id is not None:
                self.proc_ids[job_id] = proc_id

        self._mutate(fn)

    def set_proc_id(self, job_id, proc_id):
        """Record the driver's process id WITHOUT touching status.

        The async loop writes proc_id after ``driver.submit_job`` returns;
        a fast runner may have already flipped the job RUNNING/COMPLETE in
        the window, and regressing status here would destroy its result
        (the reference's bookkeeping has the same submit-then-record shape,
        main.py ≈L200)."""

        def fn():
            self.proc_ids[job_id] = proc_id

        self._mutate(fn)

    def set_candidate(self, job_id):
        self._set_state(job_id, CANDIDATE_STATE)

    def set_submitted(self, job_id, proc_id=-1):
        self._set_state(job_id, SUBMITTED_STATE, proc_id=proc_id)

    def set_running(self, job_id):
        self._set_state(job_id, RUNNING_STATE)

    def set_complete(self, job_id, value, duration):
        self._set_state(job_id, COMPLETE_STATE, value=value, duration=duration)

    def set_broken(self, job_id):
        self._set_state(job_id, BROKEN_STATE)

    def set_broken_if_pending(self, job_id) -> bool:
        """Flip to broken ONLY if still submitted/running.

        The check and the flip share ONE locked read-modify-write, so a
        runner that completes between the harness's liveness probe and
        this call can never have its result clobbered (the harness-side
        re-read in loop.detect_broken narrows the window; this closes
        it).  Returns whether the flip happened.
        """
        out = {"flipped": False}

        def fn():
            if self.status[job_id] in (SUBMITTED_STATE, RUNNING_STATE):
                self.status[job_id] = BROKEN_STATE
                out["flipped"] = True

        self._mutate(fn)
        return out["flipped"]

    def retry_broken(self, job_id, max_retries: int) -> bool:
        """Requeue a broken job as a candidate if its retry budget allows
        (SURVEY.md §5.3 build note: broken-state machine + retry budget;
        the reference burns the slot permanently)."""
        out = {"requeued": False}

        def fn():
            if (self.status[job_id] == BROKEN_STATE
                    and self.retries[job_id] < max_retries):
                self.retries[job_id] += 1
                self.status[job_id] = CANDIDATE_STATE
                self.proc_ids[job_id] = -1
                out["requeued"] = True

        self._mutate(fn)
        return out["requeued"]

    # --------------------------- runner-side status flips (classmethods)
    @classmethod
    def job_running(cls, expt_dir, job_id):
        cls(expt_dir).set_running(job_id)

    @classmethod
    def job_complete(cls, expt_dir, job_id, value, duration):
        cls(expt_dir).set_complete(job_id, value, duration)

    @classmethod
    def job_broken(cls, expt_dir, job_id):
        cls(expt_dir).set_broken(job_id)


def _as_variable_dict(v) -> dict:
    if isinstance(v, dict):
        return {
            "name": v["name"], "type": v["type"].upper(),
            "size": int(v.get("size", 1)), "min": v.get("min"),
            "max": v.get("max"), "options": list(v.get("options", [])),
        }
    # VariableSpec dataclass
    return {
        "name": v.name, "type": v.type.upper(), "size": int(v.size),
        "min": v.min, "max": v.max, "options": list(v.options),
    }


def grid_for_config(expt_dir: str, config: ExperimentConfig,
                    grid_size: int, grid_seed: int = 1) -> ExperimentGrid:
    return ExperimentGrid(
        expt_dir, variables=config.variables, grid_size=grid_size,
        grid_seed=grid_seed,
    )
