"""Uniform-random chooser (reference ``chooser/RandomChooser.py`` ≈30 LoC,
SURVEY.md §2 #17): picks a uniformly random grid candidate.

Copy of ``spearmint_tpu/choosers/RandomChooser.py`` (numpy only): with the
same seed it picks the same candidates as the JAX chooser.
"""

from __future__ import annotations

import numpy as np

from spearmint_tpu_torch.utils.args import unpack_args


def init(expt_dir, arg_string=""):
    return RandomChooser(expt_dir, **unpack_args(arg_string))


class RandomChooser:
    def __init__(self, expt_dir, seed=0):
        self.rng = np.random.RandomState(int(seed))

    def next(self, grid, values, durations, candidates, pending, complete):
        return int(candidates[int(np.floor(len(candidates) * self.rng.rand()))])
