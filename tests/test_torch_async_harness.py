"""The port's asynchronous harness (``spearmint_tpu_torch.harness.main``)
against the JAX package's: ``attempt_dispatch`` on twin experiment
directories with SequentialChooser and the fake driver (the same return
states, job ids, broken-job detection, ``--retry-broken`` requeue and
``expt-grid.npz`` arrays), an experiment resumed across the packages both
ways, ``main`` end to end with the local driver, a GP chooser fantasizing
jobs a scripted driver keeps in flight, and the refusal to fall back to
the CPU.  Then the two decisions taken on this path (ROADMAP §C): the
``max_obs_pad`` rows kept (the JAX package's ``comp[-pad:]``) and C1, the
float32 limit of the pending covariance, which both packages meet on the
same samples."""

import os
import shutil
import socket
import time
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spearmint_tpu.acquire import fantasy as jfant
from spearmint_tpu.choosers import get_chooser as jget_chooser
from spearmint_tpu.core.likelihood import GPHypers as JHypers
from spearmint_tpu.harness.drivers import get_driver as jget_driver
from spearmint_tpu.harness.main import attempt_dispatch as jattempt
from spearmint_tpu.store.experiment import ExperimentGrid as JGrid
from spearmint_tpu_torch.acquire import fantasy as tfant
from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.core.likelihood import GPHypers
from spearmint_tpu_torch.harness import main as hmain
from spearmint_tpu_torch.harness.drivers import fake, get_driver
from spearmint_tpu_torch.harness.main import attempt_dispatch
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

GRID_ARRAYS = ("grid", "status", "values", "durs", "proc_ids", "retries")

PORT = dict(attempt=attempt_dispatch, chooser=get_chooser, driver=get_driver,
            grid=ExperimentGrid)
JAX = dict(attempt=jattempt, chooser=jget_chooser, driver=jget_driver,
           grid=JGrid)


def _setup_expt(path):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.pb"), "w") as f:
        f.write(CONFIG)
    with open(os.path.join(path, "objective.py"), "w") as f:
        f.write(OBJECTIVE)
    return path, codec.load_experiment(os.path.join(path, "config.pb"))


def _arrays(expt):
    with np.load(os.path.join(expt, "expt-grid.npz")) as z:
        return {k: z[k] for k in GRID_ARRAYS}


def _script(expt, cfg, pkg, driver, steps, options):
    """Run ``steps`` against one package's harness: "poll" is one
    ``attempt_dispatch``, ("kill", i) ends the i-th submitted process
    without a result, ("finish", i) records the i-th submitted job's
    result through the store, as its runner would (a no-op for a job the
    run never submitted).  Returns each poll's state and the broken jobs
    after it."""
    chooser = pkg["chooser"]("SequentialChooser", expt)
    trace = []
    for step in steps:
        if step == "poll":
            state = pkg["attempt"](expt, cfg, chooser, driver, options)
            trace.append((state, [int(j) for j in
                                  pkg["grid"](expt).get_broken()]))
        else:
            what, i = step
            if i >= len(driver.submitted):
                continue
            pid, job = driver.submitted[i]
            if what == "finish":
                x = pkg["grid"](expt).grid[job.id]
                pkg["grid"].job_complete(expt, job.id,
                                         float(((x - 0.5) ** 2).sum()), 0.5)
            driver.kill(pid)
    return trace


STEPS = ["poll", "poll", "poll", ("kill", 0), "poll", ("finish", 1), "poll",
         "poll", ("kill", 2), ("finish", 3), "poll", "poll", ("finish", 4),
         ("finish", 5), "poll", "poll", ("finish", 6), ("finish", 7), "poll",
         "poll"]


@pytest.mark.parametrize("retry_broken", [0, 2])
def test_attempt_dispatch_matches_jax_with_the_fake_driver(tmp_path,
                                                           retry_broken):
    """Twin experiments, one script of polls, deaths and results: the same
    states ("dispatched", "full", "done"), the same job ids submitted, the
    same broken jobs (or, with ``--retry-broken``, the same requeues) and
    the same grid arrays on disk, element for element."""
    options = Namespace(grid_size=12, grid_seed=1, max_concurrent=2,
                        max_finished_jobs=5, retry_broken=retry_broken)
    out = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        expt, cfg = _setup_expt(str(tmp_path / name))
        driver = pkg["driver"]("fake")
        trace = _script(expt, cfg, pkg, driver, STEPS, options)
        out[name] = (trace, [j.id for _, j in driver.submitted],
                     [p for p, _ in driver.submitted], _arrays(expt))
    (trace, ids, pids, arrays), (jtrace, jids, jpids, jarrays) = (
        out["port"], out["jax"])
    assert trace == jtrace
    assert ids == jids and pids == jpids
    for k in GRID_ARRAYS:
        assert arrays[k].dtype == jarrays[k].dtype, k
        np.testing.assert_array_equal(arrays[k], jarrays[k], err_msg=k)
    states = [s for s, _ in trace]
    assert states[:3] == ["dispatched", "dispatched", "full"]
    assert states[-1] == "done" and "full" in states[3:]
    if retry_broken:
        # each killed job was requeued and dispatched again
        assert ids.count(ids[0]) == 3 and int(arrays["retries"][ids[0]]) == 2
        assert not any(b for _, b in trace)
    else:
        assert trace[3][1] == [ids[0]]


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_experiment_resumes_across_packages(tmp_path, first, second):
    """An experiment begun by one package's ``attempt_dispatch`` and
    resumed by the other's (the same fake driver carries the processes
    over) ends where a run of the first package alone ends."""
    pkgs = {"port": PORT, "jax": JAX}
    options = Namespace(grid_size=12, grid_seed=1, max_concurrent=2,
                        max_finished_jobs=5, retry_broken=1)
    split = 6
    expt, cfg = _setup_expt(str(tmp_path / "mixed"))
    driver = fake.init()
    mixed = (_script(expt, cfg, pkgs[first], driver, STEPS[:split], options)
             + _script(expt, cfg, pkgs[second], driver, STEPS[split:],
                       options))
    alone_dir, _ = _setup_expt(str(tmp_path / "alone"))
    alone_driver = fake.init()
    alone = _script(alone_dir, cfg, pkgs[first], alone_driver, STEPS,
                    options)
    assert mixed == alone
    assert ([j.id for _, j in driver.submitted]
            == [j.id for _, j in alone_driver.submitted])
    a, b = _arrays(expt), _arrays(alone_dir)
    for k in GRID_ARRAYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_until_settled(expt, timeout=120):
    """Wait for the jobs ``main`` left in flight (it stops dispatching,
    not running) to end."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if len(ExperimentGrid(expt).get_pending()) == 0:
            return
        time.sleep(0.2)
    raise AssertionError("jobs still pending after the harness returned")


def test_main_local_driver_end_to_end(tmp_path, monkeypatch):
    """``main`` with the local driver, SequentialChooser and the web status
    page on: every job runs in a child ``python -m
    spearmint_tpu_torch.harness.runner``, in grid order, and ends complete
    with the objective's value."""
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    expt, _ = _setup_expt(str(tmp_path))
    assert hmain.main([expt, "--driver=local", "--grid-size=10",
                       "--max-finished-jobs=3", "--max-concurrent=2",
                       "--polling-time=0.05",
                       "--chooser-module=SequentialChooser", "--web-status",
                       f"--web-status-port={_free_port()}"]) == 0
    _wait_until_settled(expt)
    grid = ExperimentGrid(expt)
    done = [int(i) for i in grid.get_complete()]
    assert len(done) >= 3 and len(grid.get_broken()) == 0
    assert done == list(range(len(done)))  # Sequential: grid order
    np.testing.assert_allclose(
        grid.values[done], ((grid.grid[done] - 0.5) ** 2).sum(1), rtol=1e-6)
    kinds = [e["kind"] for e in EventLog(expt).read()]
    assert kinds.count("dispatch") == len(done)
    assert kinds.count("complete") == len(done)
    with open(os.path.join(expt, "best_job_and_result.txt")) as f:
        assert f.read().startswith("Best result:")


class ScriptedDriver(fake.FakeDriver):
    """Keeps the two newest jobs in flight: each submission runs the job
    submitted two before it, inline, to completion."""

    def submit_job(self, job) -> int:
        pid = super().submit_job(job)
        if len(self.submitted) > 2:
            old_pid, old_job = self.submitted[-3]
            job_runner(old_job)
            self.kill(old_pid)
        return pid


def test_main_gp_chooser_fantasizes_jobs_in_flight(tmp_path, monkeypatch):
    """``main`` with the port's GPEIOptChooser on the CPU over Branin, six
    completions seeded, and a driver that keeps two jobs in flight: every
    suggestion after the second sees pending jobs and fantasizes them,
    with finite samples."""
    expt = str(tmp_path)
    for f in ("config.pb", "branin.py"):
        shutil.copy(os.path.join(BRANIN_DIR, f), expt)
    config = codec.load_experiment(os.path.join(expt, "config.pb"))
    grid = ExperimentGrid(expt, config.variables, grid_size=100,
                          grid_seed=1)
    for i in range(6):
        x1, x2 = -5.0 + 15.0 * grid.grid[i, 0], 15.0 * grid.grid[i, 1]
        grid.set_complete(i, float((x2 - 5.1 / (4 * np.pi ** 2) * x1 ** 2
                                    + 5 / np.pi * x1 - 6) ** 2
                                   + 10 * (1 - 1 / (8 * np.pi))
                                   * np.cos(x1) + 10), 1.0)
    monkeypatch.setattr(hmain, "get_driver", lambda name: ScriptedDriver())
    assert hmain.main([expt, "--driver=fake", "--grid-size=100",
                       "--max-finished-jobs=10", "--max-concurrent=3",
                       "--polling-time=0",
                       "--chooser-args=chains=2,mcmc_iters=2,burnin=5,"
                       "grid_subset=2,lbfgs_iters=3,pending_samples=5,"
                       "seed=0,device=cpu"]) == 0
    suggests = [e for e in EventLog(expt).read() if e["kind"] == "suggest"]
    assert len(suggests) == 6
    assert [e["n_pending"] for e in suggests] == [0, 1, 2, 2, 2, 2]
    assert all(e["n_ok"] > 0 for e in suggests)
    assert all(np.isfinite(e["ei_best"]) for e in suggests)
    grid = ExperimentGrid(expt)
    assert len(grid.get_complete()) == 10 and len(grid.get_pending()) == 2


def test_main_without_a_card_raises(tmp_path, monkeypatch):
    """With no card and no ``device=cpu`` the async CLI raises before it
    touches the experiment; it never moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    expt = str(tmp_path)
    for f in ("config.pb", "branin.py"):
        shutil.copy(os.path.join(BRANIN_DIR, f), expt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hmain.main([expt, "--driver=fake", "--grid-size=50",
                    "--max-finished-jobs=3",
                    "--chooser-args=chains=2,mcmc_iters=2,burnin=2"])
    assert not os.path.exists(os.path.join(expt, "expt-grid.npz"))


def test_entry_points_run_as_modules(tmp_path):
    """``python -m spearmint_tpu_torch.harness.{main,lite,watch}`` in fresh
    interpreters: lite appends a row, main starts the grid and stops at
    its budget, watch prints the experiment."""
    import subprocess
    import sys

    expt, _ = _setup_expt(str(tmp_path))
    env = {**os.environ, "PYTHONPATH": REPO}
    printed = {}
    for argv in (["lite", expt, "--n", "1", "--grid-size", "8",
                  "--chooser-module", "RandomChooser"],
                 ["main", expt, "--driver=fake", "--grid-size=8",
                  "--max-finished-jobs=0",
                  "--chooser-module=SequentialChooser"],
                 ["watch", expt, "--once"]):
        out = subprocess.run(
            [sys.executable, "-m", f"spearmint_tpu_torch.harness.{argv[0]}",
             *argv[1:]], cwd=REPO, capture_output=True, text=True,
            timeout=120, env=env)
        assert out.returncode == 0, out.stdout + out.stderr
        printed[argv[0]] = out.stdout
    with open(os.path.join(expt, "results.dat")) as f:
        assert f.read().startswith("P P ")
    assert "max finished jobs reached" in printed["main"]
    assert "spearmint-tpu experiment" in printed["watch"]
    assert "candidate: 8" in printed["watch"]


# ------------------------------------------------- decisions on this path
class _Stop(Exception):
    pass


def test_max_obs_pad_keeps_the_rows_jax_keeps(tmp_path, monkeypatch):
    """``max_obs_pad`` keeps ``comp[-pad:]`` in both packages: the highest
    grid indices among the completions, not the most recent completions.
    On a history completed in an order unlike the grid's, the port's
    chooser hands its step the same observations as the JAX chooser."""
    import spearmint_tpu.engine.suggest as jsuggest
    import spearmint_tpu_torch.engine.suggest as tsuggest

    rng = np.random.RandomState(3)
    cfg = codec.parse_text_config(CONFIG)
    grid = ExperimentGrid(str(tmp_path), cfg.variables, grid_size=40,
                          grid_seed=1)
    order = rng.permutation(40)[:24]            # completion order
    for i in order:
        grid.set_complete(int(i), float(rng.randn()), 1.0)
    complete = grid.get_complete()              # grid order, as the loop
    g, values, durs = grid.get_grid()
    candidates, pending = grid.get_candidates(), grid.get_pending()

    seen = {}

    def capture(name):
        def step(key, hypers, x, y, mask, *rest, **kw):
            seen[name] = (np.asarray(x), np.asarray(y), np.asarray(mask))
            raise _Stop
        return step

    monkeypatch.setattr(tsuggest, "suggest_step", capture("port"))
    monkeypatch.setattr(jsuggest, "suggest_step", capture("jax"))
    args = "max_obs_pad=16,burnin=0,chains=2,mcmc_iters=2"
    for name, factory, extra in (("port", get_chooser, ",device=cpu"),
                                 ("jax", jget_chooser, "")):
        expt = str(tmp_path / name)
        os.makedirs(expt)
        with pytest.raises(_Stop):
            factory("GPEIOptChooser", expt, args + extra).next(
                g, values, durs, candidates, pending, complete)
    (x, y, m), (jx, jy, jm) = seen["port"], seen["jax"]
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(m, jm)
    assert x.shape == (16, 2) and m.all()
    kept = complete[-16:]
    np.testing.assert_array_equal(x, g[kept].astype(np.float32))
    assert set(kept) != set(order[-16:])        # not the 16 most recent


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_c1_float32_pending_covariance_drops_the_same_samples(seed):
    """C1, closed as a shared float32 limit.  128 pending points under five
    samples at fixed hyperparameters: at length scales 2 and 4 the pending
    covariance kappa − βᵀβ + jitter is positive definite in float64 (least
    eigenvalue at the 2e-6 jitter floor) and indefinite in float32, and
    both packages' ``fantasize_batch`` give those two samples NaN
    fantasies and the other three finite ones: the same n_ok, 3."""
    rng = np.random.RandomState(seed)
    n, pad, p, n_fant = 60, 64, 128, 4
    ls = np.array([0.05, 0.1, 0.3, 2.0, 4.0], np.float32)
    s = ls.shape[0]
    xp = np.zeros((pad, 2), np.float32)
    xp[:n] = rng.rand(n, 2)
    yp = np.zeros(pad, np.float32)
    yp[:n] = np.sin(3 * xp[:n, 0])
    mask = np.arange(pad) < n
    pend = rng.rand(p, 2).astype(np.float32)
    pmask = np.ones(p, bool)
    h = dict(mean=np.zeros(s, np.float32), amp2=np.ones(s, np.float32),
             noise=np.full(s, 1e-3, np.float32),
             ls=np.repeat(ls[:, None], 2, 1))
    data = [torch.tensor(a) for a in (xp, yp, mask, pend, pmask)]
    th = GPHypers(*(torch.tensor(h[f]) for f in GPHypers._fields))
    _, pk32 = tfant.pending_posterior(*data, th)
    _, pk64 = tfant.pending_posterior(
        *(a.double() if a.is_floating_point() else a for a in data),
        GPHypers(*(torch.tensor(h[f]).double() for f in GPHypers._fields)))
    eig32 = torch.linalg.eigvalsh(pk32.double())[:, 0].numpy()
    eig64 = torch.linalg.eigvalsh(pk64)[:, 0].numpy()
    assert np.all(eig64 > 1.9e-6)
    assert np.all(eig32[3:] < 0) and np.all(eig32[:3] > 0)

    draws = rng.randn(s, n_fant, p).astype(np.float32)
    got = tfant.fantasize_batch(torch.tensor(draws), *data, th).numpy()
    jh = JHypers(*(jnp.asarray(h[f]) for f in JHypers._fields))
    keys = jax.random.split(jax.random.PRNGKey(seed), s)
    want = np.asarray(jax.vmap(lambda k, hh: jfant.fantasize_batch(
        k, *(jnp.asarray(a) for a in (xp, yp, mask, pend, pmask)), hh,
        n_fant))(keys, jh))
    ok, jok = np.isfinite(got).all((1, 2)), np.isfinite(want).all((1, 2))
    np.testing.assert_array_equal(ok, [True, True, True, False, False])
    np.testing.assert_array_equal(ok, jok)
    assert int(ok.sum()) == int(jok.sum()) == 3
