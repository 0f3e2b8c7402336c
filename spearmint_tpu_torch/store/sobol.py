"""Sobol quasi-random candidate grid.

JAX counterpart: ``spearmint_tpu/store/sobol.py``.  That module prefers a
native C++ generator and falls back to ``scipy.stats.qmc.Sobol``; the two
give the same points (``tests/test_native.py``), so the port uses scipy
alone and needs no native build.  ``tests/test_torch_store.py`` holds the
grid element for element to the JAX package's.

``grid_seed`` is the reference's ``skip``: the number of initial points
fast-forwarded past, so two experiments with different seeds see different
(deterministic) grids.
"""

from __future__ import annotations

import numpy as np


def sobol_grid(num_dims: int, grid_size: int, grid_seed: int = 1) -> np.ndarray:
    """(grid_size, num_dims) Sobol points in the unit hypercube."""
    from scipy.stats import qmc

    eng = qmc.Sobol(d=num_dims, scramble=False)
    if grid_seed > 0:
        eng.fast_forward(grid_seed)
    return eng.random(grid_size)
