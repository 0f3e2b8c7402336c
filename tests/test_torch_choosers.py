"""The port's choosers on the CPU: a Branin run through the JAX package's
sync harness, the state file both packages share, the grid-only chooser,
the degenerate-suggestion fallback, the memory policy and the options
(``profile_dir`` and band mode taken, unknown chooser names refused).
"""

import math
import os
import shutil
from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spearmint_tpu_torch.choosers import get_chooser

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRANIN_DIR = os.path.join(REPO, "examples", "braninpy")


def branin_unit(u):
    x, y = 15.0 * u[0] - 5.0, 15.0 * u[1]
    v = (y - (5.1 / (4 * math.pi ** 2)) * x ** 2 + (5 / math.pi) * x - 6) ** 2
    return v + 10 * (1 - 1 / (8 * math.pi)) * math.cos(x) + 10


def test_branin_chooser_through_the_sync_harness(tmp_path):
    """The JAX package's sync harness drives the port's chooser (any
    object with ``next`` will do): 16 Branin evaluations, best < 3.0, the
    budget of tests/test_e2e_branin.py.  At that budget a run of either
    package misses 3.0 from about one seed in four
    (test_branin_success_rate_matches_jax), so the seed is fixed."""
    from spearmint_tpu.harness import sync as sync_mod
    from spearmint_tpu.store import codec
    from spearmint_tpu.store.experiment import ExperimentGrid

    expt = str(tmp_path)
    shutil.copy(os.path.join(BRANIN_DIR, "config.pb"), expt)
    shutil.copy(os.path.join(BRANIN_DIR, "branin.py"), expt)
    config = codec.load_experiment(os.path.join(expt, "config.pb"))
    chooser = get_chooser(
        "GPEIOptChooser", expt,
        "mcmc_iters=3,chains=4,burnin=20,grid_subset=4,lbfgs_iters=15,"
        "seed=2,device=cpu")
    options = Namespace(grid_size=300, grid_seed=1, max_finished_jobs=16)
    best_val, _ = sync_mod.run(expt, config, chooser, options)
    assert len(ExperimentGrid(expt).get_complete()) == 16
    assert best_val < 3.0, best_val
    assert os.path.exists(os.path.join(expt, "GPEIOptChooser_state.npz"))
    kinds = [e["kind"] for e in chooser.events.read()]
    assert kinds.count("suggest") >= 10


@pytest.mark.slow
def test_branin_success_rate_matches_jax(tmp_path):
    """Seeds 0-11 of the Branin run above through both packages' choosers
    (minutes on the CPU): the port reaches best < 3.0 in at least as many
    runs as the JAX chooser, less two (binomial noise at p ≈ 0.75)."""
    from spearmint_tpu.choosers import get_chooser as jax_chooser
    from spearmint_tpu.harness import sync as sync_mod
    from spearmint_tpu.store import codec

    args = "mcmc_iters=3,chains=4,burnin=20,grid_subset=4,lbfgs_iters=15"
    best = {"port": [], "jax": []}
    for seed in range(12):
        for name, make in (("port", get_chooser), ("jax", jax_chooser)):
            expt = str(tmp_path / f"{name}{seed}")
            os.makedirs(expt)
            for f in ("config.pb", "branin.py"):
                shutil.copy(os.path.join(BRANIN_DIR, f), expt)
            config = codec.load_experiment(os.path.join(expt, "config.pb"))
            extra = ",device=cpu" if name == "port" else ""
            chooser = make("GPEIOptChooser", expt,
                           f"{args},seed={seed}{extra}")
            options = Namespace(grid_size=300, grid_seed=1,
                                max_finished_jobs=16)
            best[name].append(sync_mod.run(expt, config, chooser,
                                           options)[0])
    print("BRANIN_BEST", best)
    wins = {k: sum(b < 3.0 for b in v) for k, v in best.items()}
    assert wins["port"] >= wins["jax"] - 2, (wins, best)


def _grid_problem(n_done=6, size=40):
    rng = np.random.RandomState(3)
    grid = rng.rand(size, 2)
    values = np.full(size, np.nan)
    for i in range(n_done):
        values[i] = branin_unit(grid[i])
    complete = np.arange(n_done)
    candidates = np.arange(n_done, size)
    return grid, values, candidates, complete


def test_state_file_resumes_across_packages(tmp_path):
    """The JAX chooser writes GPEIOptChooser_state.npz, the port's chooser
    resumes it through convert.py and writes it back, and the JAX chooser
    resumes the port's file: same keys, same values."""
    from spearmint_tpu.choosers.GPEIOptChooser import (
        GPEIOptChooser as JaxChooser,
    )
    from spearmint_tpu.core.likelihood import GPHypers as JHypers

    expt = str(tmp_path)
    rng = np.random.RandomState(0)
    jc = JaxChooser(expt, chains=4)
    jc._hypers = JHypers(
        jnp.asarray(rng.uniform(-1, 1, 4), jnp.float32),
        jnp.asarray(rng.uniform(0.5, 2, 4), jnp.float32),
        jnp.asarray(rng.uniform(1e-3, 0.1, 4), jnp.float32),
        jnp.asarray(rng.uniform(0.3, 1.5, (4, 2)), jnp.float32))
    jc._key_state, jc._burned_in = 7, True
    jc._save_state()

    pc = get_chooser("GPEIOptChooser", expt,
                     "chains=4,mcmc_iters=4,grid_subset=3,lbfgs_iters=5,"
                     "device=cpu")
    pc._load_state(2)
    for a, b in zip(pc._hypers, jc._hypers):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pc._key_state == 7 and pc._burned_in
    grid, values, candidates, complete = _grid_problem()
    pc.next(grid, values, np.zeros(len(grid)), candidates,
            np.array([], int), complete)
    assert pc._key_state == 8

    with np.load(os.path.join(expt, "GPEIOptChooser_state.npz")) as z:
        assert sorted(z.files) == ["amp2", "burned_in", "key_state", "ls",
                                   "mean", "noise"]
        assert z["ls"].dtype == np.float32 and z["ls"].shape == (4, 2)
    jc2 = JaxChooser(expt, chains=4)
    jc2._load_state(2)
    for a, b in zip(jc2._hypers, pc._hypers):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jc2._key_state == 8 and jc2._burned_in


def test_grid_chooser_and_degenerate_fallback(tmp_path, monkeypatch):
    """GPEIChooser returns a grid index; a suggestion whose samples all
    failed (n_ok == 0) falls back to grid order, logs the event and keeps
    the chain states it had."""
    grid, values, candidates, complete = _grid_problem()
    args = ("chains=2,mcmc_iters=2,burnin=2,grid_subset=3,lbfgs_iters=5,"
            "device=cpu")
    os.makedirs(tmp_path / "g")
    gc = get_chooser("GPEIChooser", str(tmp_path / "g"), args)
    sel = gc.next(grid, values, np.zeros(len(grid)), candidates,
                  np.array([], int), complete)
    assert isinstance(sel, int) and sel in candidates

    from spearmint_tpu_torch.choosers import GPEIOptChooser as mod
    from spearmint_tpu_torch.engine import suggest as tsuggest

    real = tsuggest.suggest_step

    def failed(*a, **k):
        return real(*a, **k)._replace(n_ok=torch.tensor(0))

    os.makedirs(tmp_path / "o")
    oc = mod.GPEIOptChooser(str(tmp_path / "o"), chains=2, mcmc_iters=2,
                            burnin=2, grid_subset=3, lbfgs_iters=5,
                            device="cpu")
    oc.next(grid, values, np.zeros(len(grid)), candidates,
            np.array([], int), complete)
    before = [a.clone() for a in oc._hypers]
    monkeypatch.setattr(tsuggest, "suggest_step", failed)
    assert oc.next(grid, values, np.zeros(len(grid)), candidates,
                   np.array([], int), complete) == int(candidates[0])
    assert "suggest_degenerate" in [e["kind"] for e in oc.events.read()]
    # the failed sweep's chain states are not adopted (the JAX chooser
    # saves them), and the key still advances
    for a, b in zip(oc._hypers, before):
        assert torch.equal(a, b)
    with np.load(str(tmp_path / "o" / "GPEIOptChooser_state.npz")) as z:
        np.testing.assert_array_equal(z["ls"], before[3].numpy())
        assert int(z["key_state"]) == 2


def test_memory_policy_matches_jax(tmp_path):
    from spearmint_tpu.choosers.GPEIOptChooser import (
        GPEIOptChooser as JaxChooser,
    )

    for chains in (4, 10):
        ours = get_chooser("GPEIOptChooser", str(tmp_path),
                           f"chains={chains},device=cpu")
        theirs = JaxChooser(str(tmp_path), chains=chains)
        for pad in (16, 1024, 5120, 5248, 8192, 10240, 20480):
            assert ours._memory_policy(pad) == theirs._memory_policy(pad)


def test_unported_options_raise(tmp_path):
    # band mode is ported: the option is taken, and on the CPU the chooser
    # runs dense (band_gate), as the JAX chooser does off the TPU
    ch = get_chooser("GPEIOptChooser", str(tmp_path),
                     "band_joint_min=16,chains=2,mcmc_iters=2,burnin=2,"
                     "grid_subset=2,lbfgs_iters=3,device=cpu")
    assert ch.band_joint_min == 16
    rng = np.random.RandomState(0)
    grid = rng.rand(20, 2)
    values = np.full(20, np.nan)
    values[:6] = rng.randn(6)
    sel = ch.next(grid, values, np.zeros(20), np.arange(6, 20),
                  np.array([], int), np.arange(6))
    assert isinstance(sel, (int, tuple))
    ev = [e for e in ch.events.read() if e["kind"] == "suggest"][-1]
    assert ev["band_joint"] is False and ev["n_ok"] > 0
    # profile_dir is ported: the option is taken and the call writes one
    # trace that parses, holding the step's stage ranges
    prof_dir = tmp_path / "prof"
    ch = get_chooser("GPEIOptChooser", str(tmp_path),
                     f"profile_dir={prof_dir},chains=2,mcmc_iters=2,"
                     "burnin=2,grid_subset=2,lbfgs_iters=3,device=cpu")
    assert ch.profile_dir == str(prof_dir)
    sel = ch.next(grid, values, np.zeros(20), np.arange(6, 20),
                  np.array([], int), np.arange(6))
    assert isinstance(sel, (int, tuple))
    (trace_file,) = os.listdir(prof_dir)
    from spearmint_tpu_torch.utils import trace
    assert set(trace.ranges(trace.load(os.path.join(prof_dir, trace_file)),
                            trace.STAGE_PREFIX)) == {
        "stage:mcmc", "stage:caches", "stage:ei", "stage:lbfgs"}
    # the numpy-only choosers are ported (RandomChooser included): only a
    # name the registry does not know raises
    assert type(get_chooser("RandomChooser", str(tmp_path))).__name__ == \
        "RandomChooser"
    with pytest.raises(ValueError, match="unknown chooser"):
        get_chooser("NoSuchChooser", str(tmp_path))
