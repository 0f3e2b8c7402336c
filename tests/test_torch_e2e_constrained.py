"""End-to-end constrained BO through the port: the objective returns NaN
in a violating region; the port's sync harness and GPConstrainedEIChooser
(on the CPU) steer around it.  The port's counterpart of the JAX package's
tests/test_e2e_constrained.py, at its budget and with its checks."""

import os
from argparse import Namespace

import numpy as np
import pytest
import torch

from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.harness import sync as sync_mod
from spearmint_tpu_torch.store import codec
from spearmint_tpu_torch.store.experiment import ExperimentGrid

torch.set_num_threads(1)

CONFIG = """
language: PYTHON
name: "objective"
variable { name: "x" type: FLOAT size: 2 min: 0 max: 1 }
"""

# quadratic with minimum at (0.2, 0.5); x0 > 0.65 is infeasible
OBJECTIVE = """
import math

def main(job_id, params):
    x = params["x"]
    if float(x[0]) > 0.65:
        return float("nan")
    return 10 * ((float(x[0]) - 0.2) ** 2 + (float(x[1]) - 0.5) ** 2)
"""


@pytest.mark.slow
def test_constrained_sync_run(tmp_path):
    expt = str(tmp_path)
    with open(os.path.join(expt, "config.pb"), "w") as f:
        f.write(CONFIG)
    with open(os.path.join(expt, "objective.py"), "w") as f:
        f.write(OBJECTIVE)
    config = codec.load_experiment(os.path.join(expt, "config.pb"))
    chooser = get_chooser(
        "GPConstrainedEIChooser", expt,
        "mcmc_iters=2,chains=3,grid_subset=3,lbfgs_iters=10,device=cpu",
    )
    options = Namespace(grid_size=100, grid_seed=1, max_finished_jobs=14)
    best_val, best_id = sync_mod.run(expt, config, chooser, options)
    grid = ExperimentGrid(expt)
    complete = grid.get_complete()
    assert len(complete) == 14
    vals = grid.values[complete]
    # NaN violations recorded as complete-with-NaN, never the best
    assert np.isfinite(best_val)
    assert best_val < 2.0, best_val
    # the harness kept going after violations
    assert np.any(np.isnan(vals)) or np.all(grid.grid[complete, 0] <= 0.66)
