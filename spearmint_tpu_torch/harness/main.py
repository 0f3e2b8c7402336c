"""Asynchronous experiment loop — THE entry point.

JAX counterpart: ``spearmint_tpu/harness/main.py``: the same CLI, flags,
defaults, loop and files, on the port's store, loop, drivers and chooser
registry, without ``loop.enable_persistent_compile_cache`` (it configures
jax's compilation cache and has no counterpart here).

Parity: reference ``spearmint/spearmint/main.py`` (≈550 LoC, SURVEY.md
§2 #1 / §3.1): poll → detect finished/broken jobs → call chooser → write
Job file → dispatch via driver → sleep.  CLI flags mirror the
reference's optparse set (``--max-concurrent``, ``--grid-size``,
``--grid-seed``, ``--chooser-module``, ``--chooser-args``, ``--driver``,
``--polling-time``, ``--max-finished-jobs``); ``--web-status`` serves the
experiment state over HTTP (see harness/status.py).

Crash-resumable by construction: all state is on disk (SURVEY.md §5.4);
rerunning the same command resumes exactly, under either package.

The device is the GP chooser's own ``device`` argument, ``cuda`` unless
``--chooser-args`` says ``device=cpu``; with no card and no such request
the chooser raises and the run stops (it never moves to the CPU).  Jobs
still in flight are fantasized by the GP choosers.

Usage:
    python -m spearmint_tpu_torch.harness.main EXPT_DIR [config.pb] [flags]
"""

from __future__ import annotations

import argparse
import os
import time

from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.harness import loop
from spearmint_tpu_torch.harness.drivers import get_driver
from spearmint_tpu_torch.store import codec
from spearmint_tpu_torch.utils.events import EventLog


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spearmint-tpu-torch",
        description="asynchronous Bayesian-optimization harness",
    )
    p.add_argument("expt_dir", help="experiment directory")
    p.add_argument("config", nargs="?", default=None,
                   help="experiment config (default: <expt_dir>/config.pb)")
    p.add_argument("--max-concurrent", type=int, default=1)
    p.add_argument("--grid-size", type=int, default=20000)
    p.add_argument("--grid-seed", type=int, default=1)
    p.add_argument("--chooser-module", default="GPEIOptChooser")
    p.add_argument("--chooser-args", default="")
    p.add_argument("--driver", default="local")
    p.add_argument("--polling-time", type=float, default=3.0)
    p.add_argument("--max-finished-jobs", type=int, default=10000)
    p.add_argument("--retry-broken", type=int, default=0,
                   help="requeue vanished/crashed jobs up to N times "
                        "(reference burns the slot)")
    p.add_argument("--web-status", action="store_true",
                   help="serve experiment status over HTTP")
    p.add_argument("--web-status-port", type=int, default=8000)
    return p


def attempt_dispatch(expt_dir, config, chooser, driver, options) -> str:
    """One poll iteration; returns 'dispatched' | 'full' | 'done'."""
    grid = loop.open_grid(expt_dir, config, options.grid_size,
                          options.grid_seed)
    newly_broken = loop.detect_broken(grid, driver)
    max_retries = getattr(options, "retry_broken", 0)
    if max_retries:
        for job_id in newly_broken:
            if grid.retry_broken(job_id, max_retries):
                codec.log(f"job {job_id} requeued "
                          f"(retry {int(grid.retries[job_id])}/{max_retries})")

    n_finished = len(grid.get_complete()) + len(grid.get_broken())
    if n_finished >= options.max_finished_jobs:
        best_val, best_id = loop.record_best(grid)
        codec.log(f"max finished jobs reached; best={best_val:.6g} "
                  f"(job {best_id})")
        return "done"

    pending = grid.get_pending()
    if len(pending) >= options.max_concurrent:
        return "full"

    job_id = loop.choose_next(grid, chooser)
    if job_id is None:
        codec.log("grid exhausted")
        return "done"
    grid.set_submitted(job_id)
    job = loop.make_job(grid, config, job_id)
    proc_id = driver.submit_job(job)
    # Record proc_id without touching status: the runner may already have
    # flipped this job RUNNING/COMPLETE between submit_job returning and
    # this write, and set_submitted would regress it (losing the result
    # when detect_broken later sees a dead proc on a SUBMITTED job).
    grid.set_proc_id(job_id, proc_id)
    codec.log(f"submitted job {job_id} (proc {proc_id}): "
              f"{grid.unit_to_list(job_id)}")
    EventLog(expt_dir).emit("dispatch", job=job_id, proc=proc_id)
    loop.record_best(grid)
    return "dispatched"


def main(argv=None) -> int:
    options = build_parser().parse_args(argv)
    expt_dir = os.path.realpath(options.expt_dir)
    config_path = options.config or os.path.join(expt_dir, "config.pb")
    config = codec.load_experiment(config_path)
    chooser = get_chooser(options.chooser_module, expt_dir,
                          options.chooser_args)
    driver = get_driver(options.driver)

    status_server = None
    if options.web_status:
        from spearmint_tpu_torch.harness.status import serve_status

        status_server = serve_status(expt_dir, options.web_status_port)
        codec.log(f"web status at http://localhost:{options.web_status_port}")

    codec.log(f"experiment {config.name} in {expt_dir} "
              f"(chooser={options.chooser_module}, driver={options.driver})")
    try:
        while True:
            state = attempt_dispatch(expt_dir, config, chooser, driver,
                                     options)
            if state == "done":
                return 0
            # Dispatch back-to-back until concurrency is full, then poll.
            if state != "dispatched":
                time.sleep(options.polling_time)
    except KeyboardInterrupt:
        codec.log("interrupted; state is on disk — rerun to resume")
        return 130
    finally:
        if status_server is not None:
            status_server.shutdown()


def cli():
    raise SystemExit(main())


if __name__ == "__main__":
    cli()
