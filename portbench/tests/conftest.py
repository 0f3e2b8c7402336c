"""CPU tests of the benchmark (no card, no JAX).  A tiny cell runs the
port's plain kernel versions on the CPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(workload: str, completed: int = 40, grid: int = 160):
    """A cell of the manifest cut to a CPU test's size: every number but
    the sizes and the chain count as the cell states it, its limits too."""
    from portbench import cell as cellmod

    c = cellmod.load_cell(workload, ROOT)
    cfg = dict(c.config, grid_size=grid, chains=3, mcmc_iters=3, burnin=1,
               lbfgs_iters=5, grid_subset=3)
    return c._replace(config=cfg, traffic=dict(c.traffic,
                                                completed=completed))


@pytest.fixture
def tiny_cell():
    return tiny
