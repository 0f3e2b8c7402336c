"""The port's job runner and sync harness on the CPU: the runner's
languages, the best-so-far file against the JAX package's, a Branin run
through ``spearmint_tpu_torch.harness.sync`` with the port's chooser, and
the refusal to fall back to the CPU."""

import os
import shutil
import stat
from argparse import Namespace

import numpy as np
import pytest
import torch

from spearmint_tpu.harness import loop as jloop
from spearmint_tpu.store.experiment import ExperimentGrid as JGrid
from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.harness import loop, sync
from spearmint_tpu_torch.harness.runner import job_runner
from spearmint_tpu_torch.store import codec
from spearmint_tpu_torch.store.experiment import ExperimentGrid
from spearmint_tpu_torch.utils.events import EventLog

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRANIN_DIR = os.path.join(REPO, "examples", "braninpy")

CONFIG = """
language: PYTHON
name: "objective"
variable { name: "x" type: FLOAT size: 2 min: 0 max: 1 }
"""

OBJECTIVE = """
import numpy as np
def main(job_id, params):
    x = np.asarray(params["x"], dtype=float)
    return float(((x - 0.5) ** 2).sum())
"""

BROKEN_OBJECTIVE = """
def main(job_id, params):
    raise RuntimeError("boom")
"""


def _setup_expt(tmp_path, objective=OBJECTIVE, config=CONFIG):
    expt = str(tmp_path)
    with open(os.path.join(expt, "config.pb"), "w") as f:
        f.write(config)
    with open(os.path.join(expt, "objective.py"), "w") as f:
        f.write(objective)
    return expt, codec.load_experiment(os.path.join(expt, "config.pb"))


def _submit(expt, cfg, job_id):
    grid = loop.open_grid(expt, cfg, grid_size=10, grid_seed=1)
    grid.set_submitted(job_id)
    return loop.make_job(grid, cfg, job_id)


def test_runner_python_complete(tmp_path):
    expt, cfg = _setup_expt(tmp_path)
    assert job_runner(_submit(expt, cfg, 0))
    fresh = ExperimentGrid(expt)
    assert 0 in fresh.get_complete() and fresh.durs[0] >= 0
    np.testing.assert_allclose(fresh.values[0],
                               ((fresh.grid[0] - 0.5) ** 2).sum(), rtol=1e-6)
    back = codec.load_job(codec.job_file_for(expt, 0))
    assert back.status == "complete"
    assert back.value == pytest.approx(fresh.values[0])
    assert [e["kind"] for e in EventLog(expt).read()] == ["complete"]


def test_runner_marks_broken(tmp_path):
    expt, cfg = _setup_expt(tmp_path, objective=BROKEN_OBJECTIVE)
    assert not job_runner(_submit(expt, cfg, 1))
    assert 1 in ExperimentGrid(expt).get_broken()
    assert codec.load_job(codec.job_file_for(expt, 1)).status == "broken"


def test_runner_shell_language(tmp_path):
    config = CONFIG.replace("PYTHON", "SHELL").replace(
        '"objective"', '"objective.sh"')
    expt, cfg = _setup_expt(tmp_path, config=config)
    script = os.path.join(expt, "objective.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\necho evaluating\necho RESULT= 3.25\n")
    os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
    assert job_runner(_submit(expt, cfg, 0))
    assert ExperimentGrid(expt).values[0] == pytest.approx(3.25)


def test_runner_main_writes_the_job_output(tmp_path):
    """``python -m spearmint_tpu_torch.harness.runner <job-file>`` in a
    child process: exit 0, the objective's print in output/<id>.out."""
    import subprocess
    import sys

    expt, cfg = _setup_expt(
        tmp_path, objective=OBJECTIVE.replace(
            "    x = ", "    print('evaluating', job_id)\n    x = "))
    _submit(expt, cfg, 2)
    out = subprocess.run(
        [sys.executable, "-m", "spearmint_tpu_torch.harness.runner",
         codec.job_file_for(expt, 2)], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    with open(codec.job_output_file(expt, 2)) as f:
        assert "evaluating 2" in f.read()
    assert 2 in ExperimentGrid(expt).get_complete()


def test_detect_broken_flips_only_vanished_pending_jobs(tmp_path):
    """A pending job whose process is gone turns broken (with an event);
    one whose process lives, and a completed one whose process is gone,
    keep their status."""
    class Driver:
        def is_alive(self, proc_id):
            return proc_id == 2

    expt, cfg = _setup_expt(tmp_path)
    grid = loop.open_grid(expt, cfg, grid_size=10, grid_seed=1)
    grid.set_submitted(0, proc_id=1)
    grid.set_submitted(1, proc_id=2)
    grid.set_submitted(3, proc_id=3)
    ExperimentGrid.job_complete(expt, 3, 0.5, 0.1)
    assert loop.detect_broken(ExperimentGrid(expt), Driver()) == [0]
    fresh = ExperimentGrid(expt)
    assert list(fresh.get_broken()) == [0]
    assert list(fresh.get_pending()) == [1]
    assert 3 in fresh.get_complete()
    assert [e["kind"] for e in EventLog(expt).read()] == ["broken"]


def test_record_best_writes_what_jax_writes(tmp_path):
    """Same grid, same completions: both packages' best-so-far files are
    byte for byte equal."""
    texts = []
    for name, grid_cls, rec in (("port", ExperimentGrid, loop.record_best),
                                ("jax", JGrid, jloop.record_best)):
        expt = str(tmp_path / name)
        os.makedirs(expt)
        cfg = codec.parse_text_config(CONFIG)
        grid = grid_cls(expt, cfg.variables, grid_size=12, grid_seed=1)
        for i, v in ((1, 0.5), (4, 0.125), (7, np.nan)):
            grid.set_complete(i, v, 0.1)
        assert rec(grid_cls(expt)) == (0.125, 4)
        with open(os.path.join(expt, loop.BEST_FILE)) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    assert texts[0].startswith("Best result: 0.125\nJob-id: 4\n")


def test_sync_branin_with_the_port_chooser(tmp_path):
    """The port's sync harness drives the port's GPEIOptChooser on
    examples/braninpy: 16 evaluations, best < 3.0, the budget of
    tests/test_e2e_branin.py.  At that budget a run of either package
    misses 3.0 from about one seed in four, so the seed is fixed (seed 2,
    the seed of tests/test_torch_choosers.py's run through the JAX
    harness, which sees the same Sobol grid)."""
    expt = str(tmp_path)
    for f in ("config.pb", "branin.py"):
        shutil.copy(os.path.join(BRANIN_DIR, f), expt)
    config = codec.load_experiment(os.path.join(expt, "config.pb"))
    chooser = get_chooser(
        "GPEIOptChooser", expt,
        "mcmc_iters=3,chains=4,burnin=20,grid_subset=4,lbfgs_iters=15,"
        "seed=2,device=cpu")
    options = Namespace(grid_size=300, grid_seed=1, max_finished_jobs=16)
    best_val, best_id = sync.run(expt, config, chooser, options)
    grid = ExperimentGrid(expt)
    assert len(grid.get_complete()) == 16
    assert best_val < 3.0, best_val
    assert grid.get_best() == (best_val, best_id)
    assert os.path.exists(os.path.join(expt, loop.BEST_FILE))
    assert os.path.exists(os.path.join(expt, "GPEIOptChooser_state.npz"))
    kinds = [e["kind"] for e in chooser.events.read()]
    assert kinds.count("suggest") >= 10 and kinds.count("complete") == 16


def test_sync_main_without_a_card_raises(tmp_path, monkeypatch):
    """With no card and no ``device=cpu`` the CLI raises before any job
    runs; it never moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    expt = str(tmp_path)
    for f in ("config.pb", "branin.py"):
        shutil.copy(os.path.join(BRANIN_DIR, f), expt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sync.main([expt, "--grid-size=50", "--max-finished-jobs=3",
                   "--chooser-args=chains=2,mcmc_iters=2,burnin=2"])
    assert not os.path.exists(os.path.join(expt, "expt-grid.npz"))
    # the same run with device=cpu goes through
    assert sync.main([expt, "--grid-size=50", "--max-finished-jobs=3",
                      "--chooser-args=chains=2,mcmc_iters=2,burnin=2,"
                      "grid_subset=2,lbfgs_iters=3,device=cpu"]) == 0
    assert len(ExperimentGrid(expt).get_complete()) == 3
