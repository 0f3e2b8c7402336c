"""The port's spearmint-lite (``spearmint_tpu_torch.harness.lite``) against
the JAX package's: ``parse_results`` on the same files, ``suggest_batch``
with the same seeded RandomChooser writing the same rows, a GP batch whose
later rows fantasize the earlier ones, the never-re-suggest filter and the
CLI."""

import os
import shutil

import numpy as np
import pytest
import torch

from spearmint_tpu.choosers import get_chooser as jget_chooser
from spearmint_tpu.harness import lite as jlite
from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.harness import lite
from spearmint_tpu_torch.store import codec, varmap
from spearmint_tpu_torch.store.sobol import sobol_grid
from spearmint_tpu_torch.utils.events import EventLog

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRANIN_DIR = os.path.join(REPO, "examples", "braninpy")

CONFIG = """
language: PYTHON
name: "obj"
variable { name: "x" type: FLOAT size: 2 min: -1 max: 3 }
variable { name: "k" type: INT size: 1 min: 0 max: 10 }
variable { name: "m" type: ENUM size: 1 options: "a" options: "b" options: "c" }
"""


@pytest.fixture
def config():
    return codec.parse_text_config(CONFIG)


def _branin(typed):
    x1, x2 = -5.0 + 15.0 * typed[0], 15.0 * typed[1]
    return ((x2 - 5.1 / (4 * np.pi ** 2) * x1 ** 2 + 5 / np.pi * x1 - 6) ** 2
            + 10 * (1 - 1 / (8 * np.pi)) * np.cos(x1) + 10)


def _write_results(path, variables, points, value):
    with open(path, "w") as f:
        for u in points:
            typed = varmap.unit_to_typed(variables, u)
            f.write(f"{value(typed)} 1.0 "
                    + " ".join(str(t) for t in typed) + "\n")


def _read(path):
    with open(path) as f:
        return f.read()


def test_parse_results_equals_jax(tmp_path, config):
    """Completed, pending and blank rows of a mixed FLOAT/INT/ENUM file:
    the same unit points, values and durations as the JAX parser."""
    path = os.path.join(str(tmp_path), "results.dat")
    rng = np.random.RandomState(0)
    _write_results(path, config.variables, rng.rand(20, 4),
                   lambda t: (t[0] - 1) ** 2 + t[2])
    with open(path, "a") as f:
        f.write("1.5 P 0.0 1.0 5 b\n\nP P 2.0 2.0 3 a\nP P -1 3 0 c\n")
    got = lite.parse_results(path, config.variables)
    want = jlite.parse_results(path, config.variables)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    comp, vals, durs, pend = got
    assert len(comp) == 21 and len(pend) == 2
    assert durs[-1] == 1.0 and vals[-1] == 1.5
    assert varmap.unit_to_typed(config.variables, comp[-1]) == [0.0, 1.0, 5,
                                                                 "b"]
    with pytest.raises(ValueError, match="too few columns"):
        with open(path, "a") as f:
            f.write("1.0 2.0\n")
        lite.parse_results(path, config.variables)


def test_parse_results_of_450_branin_rows_equals_jax(tmp_path):
    """450 completed rows, as the card's lite phase writes them: the typed
    round trip gives back the same unit points in both packages."""
    cfg = codec.load_experiment(os.path.join(BRANIN_DIR, "config.pb"))
    path = os.path.join(str(tmp_path), "results.dat")
    _write_results(path, cfg.variables, sobol_grid(2, 450, 7), _branin)
    got = lite.parse_results(path, cfg.variables)
    want = jlite.parse_results(path, cfg.variables)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(got[0]) == 450 and not got[3]


def test_suggest_batch_with_random_chooser_writes_jax_rows(tmp_path,
                                                           config):
    """Twin results files and the same seeded RandomChooser: the port's
    batch of 4 appends the rows the JAX batch appends, byte for byte."""
    rng = np.random.RandomState(1)
    pts = rng.rand(6, 4)
    texts, rows = [], []
    for name, factory, mod in (("port", get_chooser, lite),
                               ("jax", jget_chooser, jlite)):
        expt = str(tmp_path / name)
        os.makedirs(expt)
        _write_results(os.path.join(expt, "results.dat"), config.variables,
                       pts, lambda t: (t[0] - 1) ** 2)
        chooser = factory("RandomChooser", expt, "seed=5")
        rows.append(mod.suggest_batch(expt, config, chooser, n=4,
                                      grid_size=40, grid_seed=1))
        texts.append(_read(os.path.join(expt, "results.dat")))
    assert rows[0] == rows[1]
    assert texts[0] == texts[1]
    assert texts[0].count("P P ") == 4


def test_gp_batch_fantasizes_its_own_pending_rows(tmp_path, config):
    """GPEIOptChooser on the CPU: three suggestions of one batch see 0, 1
    and 2 pending rows, give finite samples, and differ from one another
    (each later one fantasizes the earlier ones)."""
    expt = str(tmp_path)
    rng = np.random.RandomState(0)
    _write_results(os.path.join(expt, "results.dat"), config.variables,
                   rng.rand(8, 4),
                   lambda t: (t[0] - 1) ** 2 + (t[1] - 1) ** 2)
    chooser = get_chooser(
        "GPEIOptChooser", expt,
        "mcmc_iters=2,chains=3,burnin=10,grid_subset=3,lbfgs_iters=8,"
        "pending_samples=5,device=cpu")
    rows = lite.suggest_batch(expt, config, chooser, n=3, grid_size=50,
                              grid_seed=1)
    assert len(rows) == 3
    comp, _, _, pend = lite.parse_results(
        os.path.join(expt, "results.dat"), config.variables)
    assert len(comp) == 8 and len(pend) == 3
    for i in range(3):
        for j in range(i):
            assert not np.allclose(pend[i], pend[j])
    suggests = [e for e in EventLog(expt).read() if e["kind"] == "suggest"]
    assert [e["n_pending"] for e in suggests] == [0, 1, 2]
    assert all(e["n_ok"] > 0 for e in suggests)


@pytest.mark.parametrize("name", ["SequentialChooser", "GridChooser"])
def test_lite_never_resuggests_completed_points(tmp_path, config, name):
    """Base-grid rows matching observed rows leave the candidate set (the
    JAX package's tests/test_lite.py check); the one point left is
    suggested, as by the JAX lite, and then the grid is exhausted."""
    base = sobol_grid(4, 5, 1)
    for pkg, factory, mod in (("port", get_chooser, lite),
                              ("jax", jget_chooser, jlite)):
        expt = str(tmp_path / pkg)
        os.makedirs(expt)
        with open(os.path.join(expt, "results.dat"), "w") as f:
            for i in range(4):
                typed = varmap.unit_to_typed(config.variables, base[i])
                f.write(f"{float(i)} 1.0 "
                        + " ".join(str(t) for t in typed) + "\n")
        chooser = factory(name, expt, "")
        rows = mod.suggest_batch(expt, config, chooser, n=1, grid_size=5,
                                 grid_seed=1)
        assert rows == [varmap.unit_to_typed(config.variables, base[4])]
        with pytest.raises(RuntimeError, match="exhausted"):
            mod.suggest_batch(expt, config, chooser, n=1, grid_size=5,
                              grid_seed=1)
    assert (_read(os.path.join(str(tmp_path / "port"), "results.dat"))
            == _read(os.path.join(str(tmp_path / "jax"), "results.dat")))


def test_lite_cli(tmp_path, config):
    """``python -m spearmint_tpu_torch.harness.lite`` (its ``main``) on a
    fresh experiment: the JAX CLI's rows, one ``P P`` row per ``--n``."""
    for pkg, mod in (("port", lite), ("jax", jlite)):
        expt = str(tmp_path / pkg)
        os.makedirs(expt)
        with open(os.path.join(expt, "config.pb"), "w") as f:
            f.write(CONFIG)
        assert mod.main([expt, "--n", "2", "--grid-size", "20",
                         "--chooser-module", "RandomChooser",
                         "--chooser-args", "seed=3"]) == 0
    text = _read(os.path.join(str(tmp_path / "port"), "results.dat"))
    assert text == _read(os.path.join(str(tmp_path / "jax"), "results.dat"))
    assert text.count("P P ") == 2


def test_lite_gp_without_a_card_raises(tmp_path, monkeypatch):
    """With no card and no ``device=cpu`` lite's GP chooser raises before
    a row is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    expt = str(tmp_path)
    shutil.copy(os.path.join(BRANIN_DIR, "config.pb"), expt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lite.main([expt, "--n", "1", "--grid-size", "20"])
    assert not os.path.exists(os.path.join(expt, "results.dat"))
