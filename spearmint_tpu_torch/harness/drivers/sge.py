"""Sun Grid Engine driver.

JAX counterpart: ``spearmint_tpu/harness/drivers/sge.py``; the job's
command runs ``spearmint_tpu_torch.harness.runner``.

Parity: reference ``driver/sge.py`` (SURVEY.md §2 #11) — the reference's
entire "distributed backend": submission via ``qsub`` shell-out with
output redirection, job-id capture from qsub's stdout, liveness via
``qstat``.  Requires a real grid engine; it raises a clear error at
init if ``qsub`` is absent (same spirit as the reference, which
just crashes uglier).
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

from spearmint_tpu_torch.store import codec


def init():
    return SGEDriver()


class SGEDriver:
    def __init__(self):
        if shutil.which("qsub") is None or shutil.which("qstat") is None:
            raise RuntimeError(
                "SGE driver needs qsub/qstat on PATH (no grid engine here); "
                "use --driver=local"
            )

    def submit_job(self, job: codec.Job) -> int:
        job_file = codec.job_file_for(job.expt_dir, job.id)
        out_file = codec.job_output_file(job.expt_dir, job.id)
        cmd = (
            f"{sys.executable} -m spearmint_tpu_torch.harness.runner "
            f"{job_file}"
        )
        qsub = [
            "qsub", "-S", "/bin/bash", "-terse",
            "-N", f"{job.name}-{job.id}",
            "-o", out_file, "-j", "y", "-b", "y", cmd,
        ]
        out = subprocess.run(qsub, capture_output=True, text=True,
                             cwd=job.expt_dir)
        if out.returncode != 0:
            raise RuntimeError(f"qsub failed: {out.stderr}")
        m = re.search(r"(\d+)", out.stdout)
        if not m:
            raise RuntimeError(f"could not parse qsub job id: {out.stdout!r}")
        return int(m.group(1))

    def is_alive(self, proc_id: int) -> bool:
        out = subprocess.run(["qstat", "-j", str(proc_id)],
                             capture_output=True, text=True)
        return out.returncode == 0
