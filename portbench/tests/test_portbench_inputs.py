"""The inputs are a function of the seed, at the same sizes for every
seed, and the grid is the harness's."""

import numpy as np
import pytest

from portbench import cell as cellmod
from portbench.tests.conftest import ROOT


def inputs(seed, workload="per_sec.n5000.noisefree"):
    c = cellmod.load_cell(workload, ROOT)
    return cellmod.make_inputs(c.config, c.traffic, seed), c


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 40 + 3])
def test_same_seed_same_inputs(seed):
    a, c = inputs(seed)
    b, _ = inputs(seed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a.complete.shape == (c.traffic["completed"],)
    assert a.candidates.shape == (c.config["grid_size"]
                                  - c.traffic["completed"],)
    assert np.all(np.isfinite(a.values[a.complete]))
    assert abs(a.values[a.complete].mean()) < 1e-12
    assert np.all(a.durations[a.complete] > 0)


def test_seeds_differ_at_the_same_sizes():
    a, _ = inputs(11)
    b, _ = inputs(12)
    assert not np.array_equal(a.complete, b.complete)
    assert a.complete.shape == b.complete.shape
    np.testing.assert_array_equal(a.grid, b.grid)


def test_both_configs_share_values_for_a_seed():
    a, _ = inputs(5, "opt.n5000.noisefree")
    b, _ = inputs(5, "per_sec.n5000.noisefree")
    np.testing.assert_array_equal(a.values, b.values)


def test_grid_is_the_harness_grid():
    from spearmint_tpu_torch.store.sobol import sobol_grid

    np.testing.assert_array_equal(cellmod.sobol_grid(2, 20000, 1),
                                  sobol_grid(2, 20000, 1))
