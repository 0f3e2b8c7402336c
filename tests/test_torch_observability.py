"""The port's observability against the JAX package's: the web status page
(``spearmint_tpu_torch.harness.status``) and the terminal view
(``spearmint_tpu_torch.harness.watch``) read one experiment directory into
the same snapshot, serve the same JSON and page, and draw the same
sparklines; every GP chooser of the port emits its suggest event."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from spearmint_tpu.harness import status as jstatus
from spearmint_tpu.harness import watch as jwatch
from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.harness import status, watch
from spearmint_tpu_torch.store import codec
from spearmint_tpu_torch.store.experiment import ExperimentGrid
from spearmint_tpu_torch.utils.events import EventLog

torch.set_num_threads(1)

CONFIG = ('language: PYTHON name: "e" '
          'variable { name: "x" type: FLOAT size: 2 min: 0 max: 1 } '
          'variable { name: "k" type: INT size: 1 min: 0 max: 4 }')


@pytest.fixture
def expt(tmp_path):
    """An experiment with every status, a best job and an event log."""
    cfg = codec.parse_text_config(CONFIG)
    d = str(tmp_path)
    grid = ExperimentGrid(d, cfg.variables, grid_size=12, grid_seed=1)
    grid.set_complete(1, 0.75, 2.0)
    grid.set_complete(4, 0.25, 1.5)
    grid.set_complete(6, np.nan, 1.0)
    grid.set_broken(2)
    grid.set_submitted(3, proc_id=77)
    grid.set_running(5)
    log = EventLog(d)
    log.emit("dispatch", job=1, proc=123)
    for i, lat in enumerate((0.5, 0.25, 0.4, 0.125)):
        log.emit("suggest", latency_s=lat, n_obs=10 + i, n_pending=i % 3)
    log.emit("complete", job=1, value=0.75, duration_s=2.0)
    log.emit("best", value=0.75, job=1, n_complete=1)
    log.emit("best", value=0.25, job=4, n_complete=2)
    return d


def test_status_snapshot_equals_jax(expt):
    snap = status._snapshot(expt)
    assert snap == jstatus._snapshot(expt)
    assert snap["counts"] == {"candidate": 6, "submitted": 1, "running": 1,
                              "complete": 3, "broken": 1}
    assert snap["best_value"] == 0.25 and snap["best_job"] == 4


def test_watch_snapshot_and_render_equal_jax(expt, capsys):
    snap = watch.snapshot(expt)
    assert snap == jwatch.snapshot(expt)
    assert snap["latencies"] == [0.5, 0.25, 0.4, 0.125]
    assert snap["best_trace"] == [0.75, 0.25]
    out = watch.render(snap)
    assert out == jwatch.render(snap)
    assert "best: 0.25" in out and "median 0.325s" in out
    assert watch.main([expt, "--once"]) == 0
    printed = capsys.readouterr().out
    assert jwatch.main([expt, "--once"]) == 0
    assert printed == capsys.readouterr().out


def test_watch_of_an_empty_experiment_equals_jax(tmp_path):
    cfg = codec.parse_text_config(CONFIG)
    ExperimentGrid(str(tmp_path), cfg.variables, grid_size=5)
    snap = watch.snapshot(str(tmp_path))
    assert snap == jwatch.snapshot(str(tmp_path))
    assert watch.render(snap) == jwatch.render(snap)
    assert "best: —" in watch.render(snap)


@pytest.mark.parametrize("values,width", [
    ([], 40), ([1.0], 40), ([0, 1, 2, 3], 4), (list(range(100)), 10),
    ([3.0, 3.0, 3.0], 40), ([0.5, 0.25, 0.4, 0.125, 2.0, -1.0], 5)])
def test_sparkline_equals_jax(values, width):
    s = watch.sparkline(values, width=width)
    assert s == jwatch.sparkline(values, width=width)
    assert len(s) == min(len(values), width)


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=5).read()


def test_web_status_serves_what_jax_serves(expt):
    """Both servers on ephemeral ports over one experiment: the same JSON
    and the same page; each shut down in a ``finally``."""
    ours = status.serve_status(expt, 0)
    try:
        theirs = jstatus.serve_status(expt, 0)
        try:
            p, jp = ours.server_address[1], theirs.server_address[1]
            body = _get(p, "/json")
            assert json.loads(body) == json.loads(_get(jp, "/json"))
            assert body == _get(jp, "/json")
            assert json.loads(body)["counts"]["complete"] == 3
            html = _get(p, "/")
            assert html == _get(jp, "/")
            assert b"0.25" in html and b"spearmint-tpu" in html
        finally:
            theirs.shutdown()
    finally:
        ours.shutdown()


def test_all_gp_choosers_emit_suggest_events(tmp_path):
    """The port's three GP-EI choosers each emit a suggest event with the
    latency, the counts and the device (the JAX package's
    tests/test_observability.py check, on the CPU)."""
    rng = np.random.RandomState(0)
    args = ("mcmc_iters=2,chains=2,burnin=5,grid_subset=2,lbfgs_iters=5,"
            "device=cpu")
    grid = rng.rand(30, 2)
    complete = np.arange(8)
    candidates = np.arange(8, 30)
    durs = np.full(30, np.nan)
    durs[complete] = 1.0 + grid[complete, 0]
    for name in ("GPEIOptChooser", "GPEIperSecChooser",
                 "GPConstrainedEIChooser"):
        expt = str(tmp_path / name)
        os.makedirs(expt)
        values = np.full(30, np.nan)
        values[complete] = rng.randn(8)
        if name == "GPConstrainedEIChooser":
            values[complete[:2]] = np.nan  # some violations
        get_chooser(name, expt, args).next(grid, values, durs, candidates,
                                           np.array([], int), complete)
        suggests = [e for e in EventLog(expt).read()
                    if e["kind"] == "suggest"]
        assert suggests, f"{name} emitted no suggest event"
        ev = suggests[-1]
        assert ev["chooser"] == name and ev["device"] == "cpu"
        assert ev["latency_s"] > 0 and ev["n_pending"] == 0
        assert ev["n_obs"] > 0 and ev["n_cand"] == 22
