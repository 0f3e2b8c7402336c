"""Shared suggest-loop machinery for the async and sync harnesses.

JAX counterpart: ``spearmint_tpu/harness/loop.py``, of which this is a copy
on the port's own store, without ``enable_persistent_compile_cache`` (it
configures jax's compilation cache and has no counterpart here).

Parity: the body of reference ``main.py::attempt_dispatch`` ≈L200
(SURVEY.md §3.1): refresh grid state → detect vanished jobs → ask the
chooser → materialize the Job file → hand to a driver (async) or run
inline (sync) → record best-so-far.
"""

from __future__ import annotations

import os
import time

import numpy as np

from spearmint_tpu_torch.store import codec
from spearmint_tpu_torch.store.experiment import ExperimentGrid
from spearmint_tpu_torch.utils.events import EventLog

BEST_FILE = "best_job_and_result.txt"


def open_grid(expt_dir: str, config: codec.ExperimentConfig,
              grid_size: int, grid_seed: int) -> ExperimentGrid:
    return ExperimentGrid(
        expt_dir, variables=config.variables, grid_size=grid_size,
        grid_seed=grid_seed,
    )


def detect_broken(grid: ExperimentGrid, driver) -> list[int]:
    """Reference failure detection (SURVEY.md §5.3): every pending grid
    entry whose process vanished without flipping its status → broken."""
    newly_broken = []
    for job_id in grid.get_pending():
        proc_id = grid.get_proc_id(int(job_id))
        if proc_id >= 0 and not driver.is_alive(proc_id):
            # The status re-check and the flip share one locked
            # read-modify-write (set_broken_if_pending), so a runner
            # completing between the liveness probe and the flip keeps
            # its result — no TOCTOU window.
            if grid.set_broken_if_pending(int(job_id)):
                codec.log(f"job {int(job_id)} vanished; marked broken")
                EventLog(grid.expt_dir).emit(
                    "broken", job=int(job_id), reason="vanished")
                newly_broken.append(int(job_id))
    return newly_broken


def choose_next(grid: ExperimentGrid, chooser):
    """Run the chooser; returns a concrete grid index (adding invented
    off-grid points to the grid, reference main.py tuple branch)."""
    g, values, durs = grid.get_grid()
    candidates = grid.get_candidates()
    pending = grid.get_pending()
    complete = grid.get_complete()
    if len(candidates) == 0:
        return None
    selected = chooser.next(g, values, durs, candidates, pending, complete)
    if isinstance(selected, tuple):
        ei_value, new_point = selected
        job_id = grid.add_to_grid(np.clip(np.asarray(new_point), 0.0, 1.0))
        codec.log(f"chooser invented off-grid point (EI={ei_value:.4g}) "
                  f"-> grid index {job_id}")
    else:
        job_id = int(selected)
    return job_id


def make_job(grid: ExperimentGrid, config: codec.ExperimentConfig,
             job_id: int) -> codec.Job:
    job = codec.Job(
        id=job_id, expt_dir=grid.expt_dir, name=config.name,
        language=config.language, params=grid.get_params(job_id),
        status="submitted", submit_t=time.time(),
    )
    codec.save_job(job)
    return job


def record_best(grid: ExperimentGrid) -> tuple[float, int]:
    """Reference best-so-far status file (SURVEY.md §5.5)."""
    best_val, best_id = grid.get_best()
    if best_id >= 0:
        path = os.path.join(grid.expt_dir, BEST_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"Best result: {best_val:.8g}\nJob-id: {best_id}\n"
                    f"Parameters: {grid.unit_to_list(best_id)}\n")
        os.replace(tmp, path)
        EventLog(grid.expt_dir).emit(
            "best", value=best_val, job=best_id,
            n_complete=len(grid.get_complete()),
        )
    return best_val, best_id
