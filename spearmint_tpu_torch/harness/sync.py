"""Synchronous harness: suggest → run inline → record, in one process.

JAX counterpart: ``spearmint_tpu/harness/sync.py``: the same CLI, loop and
files, on the port's store, runner and chooser registry.

Parity: reference ``spearmint_sync.py`` (≈370 LoC, SURVEY.md §2 #12 /
§3.4): same chooser protocol as the async loop, no driver and no
polling — for cheap objectives and debugging.

The device is the chooser's own ``device`` argument, ``cuda`` unless
``--chooser-args`` says ``device=cpu``; with no card and no such request
the chooser raises and the run stops (it never moves to the CPU).

Usage:
    python -m spearmint_tpu_torch.harness.sync EXPT_DIR [config.pb] [flags]
"""

from __future__ import annotations

import argparse
import os

from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.harness import loop
from spearmint_tpu_torch.harness.runner import job_runner
from spearmint_tpu_torch.store import codec

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spearmint-tpu-torch-sync",
        description="synchronous Bayesian-optimization harness",
    )
    p.add_argument("expt_dir")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--grid-size", type=int, default=20000)
    p.add_argument("--grid-seed", type=int, default=1)
    p.add_argument("--chooser-module", default="GPEIOptChooser")
    p.add_argument("--chooser-args", default="")
    p.add_argument("--max-finished-jobs", type=int, default=100)
    return p


def run(expt_dir, config, chooser, options) -> tuple[float, int]:
    while True:
        grid = loop.open_grid(expt_dir, config, options.grid_size,
                              options.grid_seed)
        n_finished = len(grid.get_complete()) + len(grid.get_broken())
        if n_finished >= options.max_finished_jobs:
            break
        job_id = loop.choose_next(grid, chooser)
        if job_id is None:
            break
        grid.set_submitted(job_id)
        job = loop.make_job(grid, config, job_id)
        job_runner(job)  # inline: flips running → complete/broken itself
        grid = loop.open_grid(expt_dir, config, options.grid_size,
                              options.grid_seed)
        best_val, best_id = loop.record_best(grid)
        codec.log(f"finished {len(grid.get_complete())} jobs; "
                  f"best={best_val:.6g} (job {best_id})")
    grid = loop.open_grid(expt_dir, config, options.grid_size,
                          options.grid_seed)
    return loop.record_best(grid)


def main(argv=None) -> int:
    options = build_parser().parse_args(argv)
    expt_dir = os.path.realpath(options.expt_dir)
    config_path = options.config or os.path.join(expt_dir, "config.pb")
    config = codec.load_experiment(config_path)
    chooser = get_chooser(options.chooser_module, expt_dir,
                          options.chooser_args)
    best_val, best_id = run(expt_dir, config, chooser, options)
    codec.log(f"done: best={best_val:.6g} (job {best_id})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
