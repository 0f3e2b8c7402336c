"""Local subprocess driver.

JAX counterpart: ``spearmint_tpu/harness/drivers/local.py``.  The child
must find ``spearmint_tpu_torch`` from the experiment directory (its
working directory), as the JAX one must find ``spearmint_tpu``: install
the package or put the repository on ``PYTHONPATH``.  The child reads
and writes only the store; it never touches the card, so starting it
with ``Popen`` (fork, then exec) from a process that holds the card is
safe.

Parity: reference ``driver/local.py`` (SURVEY.md §2 #10): spawns
``python -m spearmint_tpu_torch.harness.runner <jobfile>`` detached;
liveness is an ``os.kill(pid, 0)``-style check.  Unlike the reference we
keep the Popen handle when we have it so zombies are reaped promptly; after a
crash-resume the pid check is the fallback (a pid that died without
flipping its grid status is exactly the broken-job signal, SURVEY.md
§5.3).
"""

from __future__ import annotations

import os
import subprocess
import sys

from spearmint_tpu_torch.store import codec


def init():
    return LocalDriver()


class LocalDriver:
    def __init__(self):
        self._procs: dict[int, subprocess.Popen] = {}

    def submit_job(self, job: codec.Job) -> int:
        job_file = codec.job_file_for(job.expt_dir, job.id)
        proc = subprocess.Popen(
            [sys.executable, "-m", "spearmint_tpu_torch.harness.runner",
             job_file],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            start_new_session=True,  # survives the main loop's death
            cwd=job.expt_dir,
        )
        self._procs[proc.pid] = proc
        return proc.pid

    def is_alive(self, proc_id: int) -> bool:
        if proc_id is None or proc_id < 0:
            return False
        proc = self._procs.get(proc_id)
        if proc is not None:
            return proc.poll() is None
        try:
            os.kill(proc_id, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True
