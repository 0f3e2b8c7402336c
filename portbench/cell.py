"""A cell's files, found by name, and the inputs it makes from a seed.

``BENCHMARK.json`` names each cell's configuration and traffic mix.  The
configuration is ``configs/<config>.json`` (the entry's ``file``): the
chooser and its options, the search space, the candidate grid, the
objective and durations recipes, the guarantees and the correctness
limits.  The traffic mix is ``traffic/<traffic>.json``: how many
completed and pending jobs the experiment holds and how many suggestions
a traced run profiles.  ``make_inputs`` is the one generator both read.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of the manifest, with its two files read."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(workload, config, traffic, int(w["chips"]))


def sobol_grid(num_dims: int, grid_size: int, grid_seed: int) -> np.ndarray:
    """The harness's candidate grid: scipy's unscrambled Sobol sequence
    with the first ``grid_seed`` points skipped (the reference's ``skip``)."""
    from scipy.stats import qmc

    eng = qmc.Sobol(d=num_dims, scramble=False)
    if grid_seed > 0:
        eng.fast_forward(grid_seed)
    return eng.random(grid_size)


def objective(name: str, x: np.ndarray, eps: np.ndarray,
              noise: float) -> np.ndarray:
    """The objective recipes a configuration may name."""
    if name == "sin3x0_cos2x1":
        return np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + noise * eps
    raise ValueError(f"unknown objective {name!r}")


def durations(name: str, x: np.ndarray, eps: np.ndarray,
              noise: float) -> np.ndarray:
    """The duration recipes (seconds) a configuration may name."""
    if name == "exp_2x0":
        return np.exp(2.0 * x[:, 0] + noise * eps)
    raise ValueError(f"unknown durations {name!r}")


class Inputs(NamedTuple):
    grid: np.ndarray        # [G, D] float64
    values: np.ndarray      # [G], NaN where not completed
    durations: np.ndarray   # [G], NaN where not completed
    complete: np.ndarray    # completed grid indices, ascending
    pending: np.ndarray     # pending grid indices, ascending
    candidates: np.ndarray  # the rest of the grid, ascending


def make_inputs(config: dict, traffic: dict, seed: int) -> Inputs:
    """The experiment a run asks its suggestions of, from ``seed``.  Every
    seed gives the same sizes: ``completed`` and ``pending`` grid points
    drawn without replacement, the objective (centred) and the durations
    at the completed points."""
    grid = sobol_grid(config["num_dims"], config["grid_size"],
                      config["grid_seed"])
    g = grid.shape[0]
    n, p = int(traffic["completed"]), int(traffic["pending"])
    rng = np.random.default_rng([int(seed), 0x5EED])
    picked = rng.choice(g, n + p, replace=False)
    complete = np.sort(picked[:n])
    pending = np.sort(picked[n:])
    taken = np.zeros(g, bool)
    taken[picked] = True
    candidates = np.flatnonzero(~taken)
    x = grid[complete]
    obj = config["objective"]
    y = objective(obj["name"], x, rng.standard_normal(n), obj["noise"])
    if obj.get("centre", False):
        y = y - y.mean()
    dur = config["durations"]
    secs = durations(dur["name"], x, rng.standard_normal(n), dur["noise"])
    values = np.full(g, np.nan)
    values[complete] = y
    durs = np.full(g, np.nan)
    durs[complete] = secs
    return Inputs(grid, values, durs, complete, pending, candidates)


def chooser_args(config: dict, seed: int, device: str) -> dict:
    """The chooser's keyword options: the configuration's, the run's seed
    as its chain seed, and the device."""
    return {**{k: config[k] for k in config["chooser_options"]},
            "seed": int(seed), "device": device}
