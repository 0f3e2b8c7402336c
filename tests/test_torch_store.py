"""The port's store against the JAX package's: the Sobol grid element for
element, config parsing, job files and experiment grids written by one
package and read by the other, the grid's status flips and the locker."""

import glob
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from spearmint_tpu.store import codec as jcodec
from spearmint_tpu.store import sobol as jsobol
from spearmint_tpu.store import varmap as jvarmap
from spearmint_tpu.store.experiment import ExperimentGrid as JGrid
from spearmint_tpu_torch.store import codec, sobol, varmap
from spearmint_tpu_torch.store.experiment import ExperimentGrid
from spearmint_tpu_torch.store.locker import Locker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "examples", "*", "config.pb")))

CONFIG_PB = """
# comment
language: PYTHON
name: "mixed"
variable { name: "X" type: FLOAT size: 2 min: -5 max: 10 }
variable { name: "k" type: INT size: 1 min: 0 max: 4 }
variable { name: "act" type: ENUM size: 1 options: "relu" options: "tanh" }
"""

GRID_ARRAYS = ("grid", "status", "values", "durs", "proc_ids", "retries")


@pytest.mark.parametrize("dims", [1, 2, 6, 20])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sobol_grid_equals_jax(dims, seed):
    want = jsobol.sobol_grid(dims, 257, seed)
    got = sobol.sobol_grid(dims, 257, seed)
    assert got.dtype == want.dtype and got.shape == (257, dims)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(os.path.dirname(p))
                              for p in CONFIGS])
def test_text_and_json_configs_parse_as_jax(path):
    assert len(CONFIGS) >= 4
    ours, theirs = codec.load_experiment(path), jcodec.load_experiment(path)
    assert ours.__dict__.keys() == theirs.__dict__.keys()
    assert (ours.name, ours.language, ours.grid_dims) == (
        theirs.name, theirs.language, theirs.grid_dims)
    assert [v.__dict__ for v in ours.variables] == [
        v.__dict__ for v in theirs.variables]
    import json

    as_json = json.dumps({"name": ours.name, "language": ours.language,
                          "variables": [v.__dict__ for v in ours.variables]})
    a, b = codec.parse_json_config(as_json), jcodec.parse_json_config(as_json)
    assert [v.__dict__ for v in a.variables] == [
        v.__dict__ for v in b.variables]
    for bad in ('variable { name: "x" type: FLOAT }',
                'variable { name: "e" type: ENUM }'):
        with pytest.raises(ValueError):
            codec.parse_text_config(bad)


def test_job_files_cross_packages(tmp_path):
    params = [codec.Parameter(name="X", dbl_val=[0.1, 0.9]),
              codec.Parameter(name="k", int_val=[3]),
              codec.Parameter(name="act", str_val=["tanh"])]
    job = codec.Job(id=7, expt_dir=str(tmp_path), name="branin",
                    language="PYTHON", params=params, value=1.5,
                    duration=0.25, status="complete")
    back = jcodec.load_job(codec.save_job(job))
    assert back.__dict__.keys() == job.__dict__.keys()
    assert [p.__dict__ for p in back.params] == [p.__dict__ for p in params]
    assert (back.id, back.value, back.duration, back.status) == (
        7, 1.5, 0.25, "complete")
    jjob = jcodec.Job(id=8, expt_dir=str(tmp_path), name="b",
                      language="SHELL",
                      params=[jcodec.Parameter(name="X", dbl_val=[0.5])])
    ours = codec.load_job(jcodec.save_job(jjob))
    assert ours.id == 8 and ours.language == "SHELL"
    d = codec.params_to_dict(ours.params)
    np.testing.assert_array_equal(d["X"], [0.5])
    assert codec.job_file_for(str(tmp_path), 8) == jcodec.job_file_for(
        str(tmp_path), 8)


def test_varmap_matches_jax():
    cfg = codec.parse_text_config(CONFIG_PB)
    pts = sobol.sobol_grid(4, 16, 3)
    for p in pts:
        typed = varmap.unit_to_typed(cfg.variables, p)
        assert typed == jvarmap.unit_to_typed(cfg.variables, p)
        toks = [str(t) for t in typed]
        np.testing.assert_array_equal(
            varmap.typed_to_unit(cfg.variables, toks),
            jvarmap.typed_to_unit(cfg.variables, toks))
    assert varmap.grid_dims(cfg.variables) == 4


def test_grid_lifecycle(tmp_path):
    expt = str(tmp_path)
    cfg = codec.parse_text_config(CONFIG_PB)
    grid = ExperimentGrid(expt, cfg.variables, grid_size=50, grid_seed=1)
    assert grid.grid.shape == (50, 4) and len(grid.get_candidates()) == 50
    grid.set_submitted(3, proc_id=42)
    assert 3 in grid.get_pending() and grid.get_proc_id(3) == 42
    ExperimentGrid.job_running(expt, 3)
    assert 3 in ExperimentGrid(expt).get_running()
    ExperimentGrid.job_complete(expt, 3, 1.25, 0.5)
    fresh = ExperimentGrid(expt)
    assert 3 in fresh.get_complete() and fresh.get_best() == (1.25, 3)
    fresh.set_submitted(5)
    ExperimentGrid.job_broken(expt, 5)
    assert 5 in ExperimentGrid(expt).get_broken()
    # the broken job is requeued once, then its budget is spent
    assert fresh.retry_broken(5, max_retries=1)
    assert 5 in ExperimentGrid(expt).get_candidates()
    fresh.set_broken(5)
    assert not fresh.retry_broken(5, max_retries=1)
    # decoding: FLOAT scaled, INT rounded, ENUM indexed
    grid.grid[0] = np.array([0.0, 1.0, 0.5, 0.99])
    assert grid.unit_to_list(0) == [-5.0, 10.0, 2, "tanh"]


def test_add_to_grid_and_broken_if_pending(tmp_path):
    expt = str(tmp_path)
    cfg = codec.parse_text_config(CONFIG_PB)
    grid = ExperimentGrid(expt, cfg.variables, grid_size=8)
    assert grid.add_to_grid(np.full(4, 0.5)) == 8
    fresh = ExperimentGrid(expt)
    assert fresh.grid.shape == (9, 4) and 8 in fresh.get_candidates()
    with pytest.raises(ValueError):
        grid.add_to_grid(np.full(3, 0.5))
    # the runner completes between the liveness probe and the flip: the
    # result survives; a job still pending flips
    grid.set_submitted(3, proc_id=12345)
    ExperimentGrid.job_complete(expt, 3, 0.7, 0.5)
    assert grid.set_broken_if_pending(3) is False
    assert float(ExperimentGrid(expt).values[3]) == 0.7
    grid.set_submitted(5, proc_id=23456)
    assert grid.set_broken_if_pending(5) is True
    assert 5 in ExperimentGrid(expt).get_broken()
    # a proc id recorded after the runner finished keeps the status
    grid.set_submitted(6)
    ExperimentGrid.job_complete(expt, 6, 0.4, 0.01)
    grid.set_proc_id(6, 99)
    fresh = ExperimentGrid(expt)
    assert 6 in fresh.get_complete() and fresh.get_proc_id(6) == 99


def _hold_lock(path, hold, q):
    lk = Locker(path)
    lk.lock_wait()
    q.put("locked")
    import time

    time.sleep(hold)
    lk.unlock()


def test_locker_excludes_other_processes(tmp_path):
    path = str(tmp_path / "x")
    q = mp.get_context("spawn").Queue()
    p = mp.get_context("spawn").Process(target=_hold_lock,
                                        args=(path, 0.6, q))
    p.start()
    try:
        assert q.get(timeout=30) == "locked"
        lk = Locker(path)
        assert not lk.lock()
        assert lk.lock_wait(timeout=10)
        lk.unlock()
    finally:
        p.join(timeout=30)
    assert not p.is_alive()


def _advance(grid_cls, expt, job_ids):
    g = grid_cls(expt)
    g.set_submitted(job_ids[0], proc_id=11)
    grid_cls.job_running(expt, job_ids[0])
    grid_cls.job_complete(expt, job_ids[0], 0.25, 1.5)
    g.set_submitted(job_ids[1])
    grid_cls.job_broken(expt, job_ids[1])
    g.retry_broken(job_ids[1], max_retries=2)
    g.add_to_grid(np.linspace(0.1, 0.9, g.num_dims))
    g.set_submitted(job_ids[2], proc_id=33)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_grid_resumes_across_packages(tmp_path, first):
    """An experiment made and advanced by one package's store opens under
    the other's with identical arrays, and advances there."""
    makers = {"jax": JGrid, "port": ExperimentGrid}
    other = "port" if first == "jax" else "jax"
    expt = str(tmp_path)
    cfg = codec.parse_text_config(CONFIG_PB)
    makers[first](expt, cfg.variables, grid_size=40, grid_seed=7)
    _advance(makers[first], expt, [2, 4, 6])
    a, b = makers[first](expt), makers[other](expt)
    for name in GRID_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.variables, a.num_dims, a.grid_seed) == (
        b.variables, b.num_dims, b.grid_seed)
    _advance(makers[other], expt, [8, 9, 10])
    c = makers[first](expt)
    assert c.get_best() == (0.25, 2) and c.grid.shape == (42, 4)
    assert sorted(c.get_pending()) == [6, 10]
