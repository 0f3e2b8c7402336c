"""Job runner — the child-process entry that executes user objectives.

Copy of ``spearmint_tpu/harness/runner.py`` on the port's own store (the
port imports nothing of the JAX package).  Run as
``python -m spearmint_tpu_torch.harness.runner <job-file>``.

Parity: reference ``runner.py`` (≈220 LoC, SURVEY.md §2 #8 / §3.3):
loads the job file, redirects stdout/stderr to ``output/<id>.out``,
flips the grid status to running, dispatches on ``job.language``, times
the evaluation, writes value+duration back, and flips the status to
complete/broken under the store lock.  Everything is filesystem IPC —
the runner never talks to the suggest loop directly, so it can run on
any machine sharing the experiment directory.

Language contracts:
  PYTHON — ``sys.path.insert(0, expt_dir)``; import ``job.name``; call
           ``main(job_id, params_dict)`` → float.
  SHELL  — run ``<expt_dir>/<job.name> <job_file>``; the program prints
           its result as the LAST whitespace-separated float on stdout
           (canonically a final line ``RESULT= <float>``).  Exercised by
           examples/braninc (the C objective).
  MATLAB/MCR — command composed as the reference does (``matlab
           -nodisplay -nojvm -r``); requires a matlab on PATH, so it is
           gated with a clear error in this image.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
import traceback

from spearmint_tpu_torch.store import codec
from spearmint_tpu_torch.store.experiment import ExperimentGrid
from spearmint_tpu_torch.utils.events import EventLog


def python_launcher(job: codec.Job) -> float:
    # Load the objective fresh from <expt_dir>/<name>.py so two
    # experiments with same-named modules never collide in sys.modules
    # (the reference's bare __import__ has that hazard).
    mod_file = os.path.join(job.expt_dir, job.name + ".py")
    params = codec.params_to_dict(job.params)
    if os.path.exists(mod_file):
        spec = importlib.util.spec_from_file_location(
            f"_spearmint_objective_{abs(hash(job.expt_dir))}_{job.name}",
            mod_file,
        )
        module = importlib.util.module_from_spec(spec)
        sys.path.insert(0, job.expt_dir)
        try:
            spec.loader.exec_module(module)
            result = module.main(job.id, params)
        finally:
            sys.path.remove(job.expt_dir)
    else:  # package-style objective: reference __import__ semantics
        sys.path.insert(0, job.expt_dir)
        try:
            module = importlib.import_module(job.name)
            result = module.main(job.id, params)
        finally:
            sys.path.remove(job.expt_dir)
    return float(result)


def shell_launcher(job: codec.Job) -> float:
    prog = os.path.join(job.expt_dir, job.name)
    job_file = codec.job_file_for(job.expt_dir, job.id)
    out = subprocess.run(
        [prog, job_file], capture_output=True, text=True, cwd=job.expt_dir,
    )
    sys.stdout.write(out.stdout)
    sys.stderr.write(out.stderr)
    if out.returncode != 0:
        raise RuntimeError(f"shell objective exited {out.returncode}")
    result = None
    for tok in out.stdout.split():
        try:
            result = float(tok)
        except ValueError:
            continue
    if result is None:
        raise RuntimeError("shell objective printed no float result")
    return result


def matlab_launcher(job: codec.Job) -> float:
    """Reference runner.py matlab_launcher parity: compose a
    ``matlab -nodisplay -nojvm -r`` command evaluating
    ``<name>(job_id, params)`` with params as a struct literal, result
    written to a side file.  Gated: raises clearly without a MATLAB."""
    import shutil
    import tempfile

    if shutil.which("matlab") is None:
        raise RuntimeError(
            "MATLAB language requires a matlab installation on PATH"
        )
    fields = []
    for p in job.params:
        if p.dbl_val:
            vals = ", ".join(repr(v) for v in p.dbl_val)
            fields.append(f"'{p.name}', [{vals}]")
        elif p.int_val:
            vals = ", ".join(repr(v) for v in p.int_val)
            fields.append(f"'{p.name}', [{vals}]")
        else:
            vals = ", ".join("'" + s.replace("'", "''") + "'"
                             for s in p.str_val)
            fields.append(f"'{p.name}', {{{vals}}}")
    params_ml = "struct(" + ", ".join(fields) + ")"
    with tempfile.NamedTemporaryFile("r", suffix=".txt",
                                     delete=False) as tf:
        result_file = tf.name
    script = (
        f"cd('{job.expt_dir}'); "
        f"r = {job.name}({job.id}, {params_ml}); "
        f"fid = fopen('{result_file}', 'w'); "
        "fprintf(fid, '%.17g\\n', r); fclose(fid); exit"
    )
    out = subprocess.run(
        ["matlab", "-nodisplay", "-nojvm", "-r", script],
        capture_output=True, text=True, cwd=job.expt_dir,
    )
    sys.stdout.write(out.stdout)
    sys.stderr.write(out.stderr)
    try:
        with open(result_file) as f:
            return float(f.read().strip())
    finally:
        os.unlink(result_file)


_LAUNCHERS = {
    "PYTHON": python_launcher,
    "SHELL": shell_launcher,
    "MATLAB": matlab_launcher,
    "MCR": matlab_launcher,
}


def job_runner(job: codec.Job) -> bool:
    """Execute one job; returns True on success.  Mirrors §3.3."""
    out_file = codec.job_output_file(job.expt_dir, job.id)
    os.makedirs(os.path.dirname(out_file), exist_ok=True)

    ExperimentGrid.job_running(job.expt_dir, job.id)
    job.status = "running"
    job.start_t = time.time()
    codec.save_job(job)

    launcher = _LAUNCHERS.get(job.language)
    try:
        if launcher is None:
            raise ValueError(f"unknown job language {job.language!r}")
        start = time.time()
        value = launcher(job)
        duration = time.time() - start
        job.value = value
        job.duration = duration
        job.end_t = time.time()
        job.status = "complete"
        codec.save_job(job)
        ExperimentGrid.job_complete(job.expt_dir, job.id, value, duration)
        codec.log(f"job {job.id} complete: value={value:.6g} "
                  f"duration={duration:.2f}s")
        EventLog(job.expt_dir).emit(
            "complete", job=job.id, value=value,
            duration_s=round(duration, 3))
        return True
    except Exception:
        traceback.print_exc()
        job.status = "broken"
        job.end_t = time.time()
        codec.save_job(job)
        ExperimentGrid.job_broken(job.expt_dir, job.id)
        codec.log(f"job {job.id} broken")
        EventLog(job.expt_dir).emit("broken", job=job.id, reason="crashed")
        return False


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m spearmint_tpu_torch.harness.runner "
              "<job-file>", file=sys.stderr)
        return 2
    job = codec.load_job(argv[0])
    out_file = codec.job_output_file(job.expt_dir, job.id)
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    # Reference behavior: the runner's own stdout/stderr land in
    # output/<id>.out.
    with open(out_file, "a", buffering=1) as f:
        os.dup2(f.fileno(), sys.stdout.fileno())
        os.dup2(f.fileno(), sys.stderr.fileno())
        ok = job_runner(job)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
