"""The port's job drivers (``spearmint_tpu_torch.harness.drivers``): the
registry, the fake driver against the JAX one, the local driver running
``python -m spearmint_tpu_torch.harness.runner`` in a child process, and
the SGE driver against fake ``qsub``/``qstat`` binaries (the fixture of
the JAX package's tests/test_sge_driver.py)."""

import os
import stat
import sys
import time

import pytest
import torch

from spearmint_tpu.harness.drivers import fake as jfake
from spearmint_tpu.harness.drivers import sge as jsge
from spearmint_tpu_torch.harness import loop
from spearmint_tpu_torch.harness.drivers import _KNOWN, fake, get_driver, sge
from spearmint_tpu_torch.store import codec
from spearmint_tpu_torch.store.experiment import ExperimentGrid

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = """
language: PYTHON
name: "objective"
variable { name: "x" type: FLOAT size: 2 min: 0 max: 1 }
"""

OBJECTIVE = """
import time
def main(job_id, params):
    time.sleep(0.5)
    return float(sum(params["x"]))
"""


def test_registry_knows_the_jax_drivers():
    from spearmint_tpu.harness.drivers import _KNOWN as jknown

    assert _KNOWN == jknown
    assert isinstance(get_driver("fake"), fake.FakeDriver)
    assert type(get_driver("local")).__name__ == "LocalDriver"
    with pytest.raises(ValueError, match="unknown driver"):
        get_driver("condor")


def test_fake_driver_matches_jax():
    """The same process ids, records and scripted liveness."""
    ours, theirs = fake.init(), jfake.init()
    for job in ("a", "b", "c"):
        assert ours.submit_job(job) == theirs.submit_job(job)
    ours.kill(1001)
    theirs.kill(1001)
    assert ours.submitted == theirs.submitted
    for pid in (999, 1000, 1001, 1002):
        assert ours.is_alive(pid) == theirs.is_alive(pid)


def test_local_driver_runs_the_port_runner(tmp_path, monkeypatch):
    """A job submitted through the local driver runs in a child ``python
    -m spearmint_tpu_torch.harness.runner`` started in the experiment
    directory; it is alive while the objective runs, then complete."""
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    expt = str(tmp_path)
    with open(os.path.join(expt, "config.pb"), "w") as f:
        f.write(CONFIG)
    with open(os.path.join(expt, "objective.py"), "w") as f:
        f.write(OBJECTIVE)
    cfg = codec.load_experiment(os.path.join(expt, "config.pb"))
    grid = loop.open_grid(expt, cfg, grid_size=10, grid_seed=1)
    grid.set_submitted(3)
    job = loop.make_job(grid, cfg, 3)
    driver = get_driver("local")
    pid = driver.submit_job(job)
    assert driver.is_alive(pid)
    deadline = time.time() + 120
    while driver.is_alive(pid) and time.time() < deadline:
        time.sleep(0.1)
    assert not driver.is_alive(pid)
    fresh = ExperimentGrid(expt)
    assert 3 in fresh.get_complete()
    assert fresh.values[3] == pytest.approx(float(fresh.grid[3].sum()))
    back = codec.load_job(codec.job_file_for(expt, 3))
    assert back.status == "complete" and back.start_t >= back.submit_t
    # after a crash-resume the driver has no handle: the pid check
    resumed = get_driver("local")
    assert resumed.is_alive(os.getpid())
    assert not resumed.is_alive(-1) and not resumed.is_alive(None)


# ------------------------------------------------------------------ SGE
def _fake_bin(tmp_path, name, script):
    p = tmp_path / "bin" / name
    p.parent.mkdir(exist_ok=True)
    p.write_text("#!/bin/sh\n" + script)
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return p


@pytest.fixture
def fake_sge(tmp_path, monkeypatch):
    # qsub: record argv, print a -terse style job id
    _fake_bin(tmp_path, "qsub",
              'echo "$@" > "$(dirname "$0")/qsub_args"\necho 4242\n')
    # qstat: alive only for job id 4242
    _fake_bin(tmp_path, "qstat",
              '[ "$2" = "4242" ] && exit 0\n'
              'echo "job not found" >&2\nexit 1\n')
    monkeypatch.setenv("PATH", f"{tmp_path}/bin:{os.environ['PATH']}")
    return tmp_path


def _job(tmp_path):
    expt = tmp_path / "expt"
    (expt / "jobs").mkdir(parents=True, exist_ok=True)
    (expt / "output").mkdir(exist_ok=True)
    return codec.Job(id=7, expt_dir=str(expt), name="branin",
                     language="PYTHON", params={"X": [0.1, 0.2]})


def test_sge_init_raises_clearly_without_grid_engine(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # empty PATH: no qsub
    with pytest.raises(RuntimeError, match="qsub/qstat"):
        sge.init()


def test_sge_submit_composes_the_port_runner_command(fake_sge):
    """The qsub line is the JAX driver's with the port's runner module."""
    job = _job(fake_sge)
    assert sge.init().submit_job(job) == 4242
    argv = (fake_sge / "bin" / "qsub_args").read_text()
    assert jsge.init().submit_job(job) == 4242
    jargv = (fake_sge / "bin" / "qsub_args").read_text()
    assert "-terse" in argv
    assert (f"{sys.executable} -m spearmint_tpu_torch.harness.runner "
            f"{codec.job_file_for(job.expt_dir, job.id)}") in argv
    assert codec.job_output_file(job.expt_dir, job.id) in argv
    assert argv == jargv.replace("spearmint_tpu.harness.runner",
                                 "spearmint_tpu_torch.harness.runner")


def test_sge_liveness_via_qstat(fake_sge):
    drv = sge.init()
    assert drv.is_alive(4242) is True
    assert drv.is_alive(9999) is False


def test_sge_submit_failure_surfaces_stderr(fake_sge):
    _fake_bin(fake_sge, "qsub", 'echo "queue rejected" >&2\nexit 1\n')
    with pytest.raises(RuntimeError, match="qsub failed"):
        sge.init().submit_job(_job(fake_sge))
    _fake_bin(fake_sge, "qsub", 'echo "no id here"\n')
    with pytest.raises(RuntimeError, match="could not parse"):
        sge.init().submit_job(_job(fake_sge))
