"""The port's RandomForestEIChooser against the JAX package's: with the
same seed the same candidate, with and without pending jobs (the
problems of the JAX package's tests/test_rf_chooser.py)."""

import numpy as np
import pytest

pytest.importorskip("sklearn")

from spearmint_tpu.choosers import get_chooser as jget_chooser  # noqa: E402
from spearmint_tpu_torch.choosers import get_chooser  # noqa: E402


def _problem(rng, n_grid=200, n_complete=100):
    grid = rng.rand(n_grid, 2)
    values = np.full(n_grid, np.nan)
    durations = np.full(n_grid, np.nan)
    complete = np.arange(n_complete)
    values[complete] = np.sum((grid[complete] - 0.25) ** 2, axis=1)
    return grid, values, durations, complete


def _pair(tmp_path, args="n_trees=40,seed=1"):
    return (get_chooser("RandomForestEIChooser", str(tmp_path), args),
            jget_chooser("RandomForestEIChooser", str(tmp_path), args))


def test_same_index_as_jax_without_pending(tmp_path, rng):
    ours, theirs = _pair(tmp_path)
    grid, values, durations, complete = _problem(rng)
    cands = np.arange(100, 200)
    none = np.array([], int)
    # bootstrap: < 2 completes → first candidate
    assert ours.next(grid, values, durations, cands, none, none[:0]) == \
        theirs.next(grid, values, durations, cands, none, none[:0]) == 100
    idx = ours.next(grid, values, durations, cands, none, complete)
    assert idx == theirs.next(grid, values, durations, cands, none,
                              complete)
    assert idx in cands
    # in the low-value basin, not the far corner
    assert np.sum((grid[idx] - 0.25) ** 2) < np.median(
        np.sum((grid[cands] - 0.25) ** 2, axis=1))


def test_same_index_as_jax_with_pending(tmp_path, rng):
    """Pending jobs fantasized by the forest's mean: the same second pick
    as the JAX chooser's, away from the first."""
    ours, theirs = _pair(tmp_path)
    grid, values, durations, complete = _problem(rng, n_complete=80)
    cands = np.arange(100, 200)
    first = ours.next(grid, values, durations, cands, np.array([], int),
                      complete)
    assert first == theirs.next(grid, values, durations, cands,
                                np.array([], int), complete)
    pend = np.array([first, 150 if first != 150 else 151])
    rest = cands[~np.isin(cands, pend)]
    second = ours.next(grid, values, durations, rest, pend, complete)
    assert second == theirs.next(grid, values, durations, rest, pend,
                                 complete)
    assert second != first
