"""The port's chooser registry against the JAX package's: the same names in
the same order, every chooser a valid suggestion on the CPU through the
``next(...)`` protocol (the JAX package's tests/test_chooser_registry.py),
and the numpy-only choosers (Random, Sequential, Grid) walking the grid in
the JAX choosers' order."""

import numpy as np
import pytest
import torch

from spearmint_tpu.choosers import _KNOWN as JKNOWN
from spearmint_tpu.choosers import get_chooser as jget_chooser
from spearmint_tpu_torch.choosers import _KNOWN, get_chooser

torch.set_num_threads(1)


def _toy(n_complete=4):
    rng = np.random.RandomState(0)
    grid = rng.rand(24, 2)
    complete = np.arange(n_complete)
    values = np.full(24, np.nan)
    values[complete] = np.sin(3 * grid[complete, 0])
    durations = np.full(24, np.nan)
    durations[complete] = 0.5
    candidates = np.arange(n_complete, 24)
    pending = np.array([], int)
    return grid, values, durations, candidates, pending, complete


def test_known_equals_jax():
    assert _KNOWN == JKNOWN


@pytest.mark.parametrize("name", _KNOWN)
def test_chooser_produces_valid_suggestion(name, tmp_path):
    args = ("mcmc_iters=2,burnin=3,chains=2,device=cpu"
            if name.startswith("GP") else "")
    ch = get_chooser(name, str(tmp_path), args)
    grid, values, durations, candidates, pending, complete = _toy()
    out = ch.next(grid, values, durations, candidates, pending, complete)
    if isinstance(out, tuple):
        ei, pt = out
        assert np.isfinite(float(ei))
        pt = np.asarray(pt)
        assert pt.shape == (2,)
        assert np.all((pt >= 0) & (pt <= 1))
    else:
        assert int(out) in set(int(c) for c in candidates)


def test_unknown_chooser_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown chooser"):
        get_chooser("NoSuchChooser", str(tmp_path))


@pytest.mark.parametrize("name,args", [("GridChooser", ""),
                                       ("SequentialChooser", ""),
                                       ("RandomChooser", "seed=4")])
def test_numpy_choosers_walk_the_grid_as_jax(name, args, tmp_path):
    """Twelve suggestions, each taken out of the candidates and marked
    pending as the harness does: the port's picks are the JAX chooser's,
    in the same order."""
    picks = []
    for factory in (get_chooser, jget_chooser):
        ch = factory(name, str(tmp_path), args)
        grid, values, durations, candidates, _, complete = _toy()
        pending, order = [], []
        for _ in range(12):
            sel = ch.next(grid, values, durations, candidates,
                          np.array(pending, int), complete)
            assert isinstance(sel, int) and sel in candidates
            order.append(sel)
            pending.append(sel)
            candidates = candidates[candidates != sel]
        picks.append(order)
    assert picks[0] == picks[1]
    if name != "RandomChooser":
        assert picks[0] == list(range(4, 16))
