"""Sequential chooser (reference ``chooser/SequentialChooser.py`` ≈30 LoC,
SURVEY.md §2 #17): walks the Sobol grid in order — the candidate list is
already in grid order, so take its head.

Copy of ``spearmint_tpu/choosers/SequentialChooser.py``.
"""

from __future__ import annotations

from spearmint_tpu_torch.utils.args import unpack_args


def init(expt_dir, arg_string=""):
    return SequentialChooser(expt_dir, **unpack_args(arg_string))


class SequentialChooser:
    def __init__(self, expt_dir):
        pass

    def next(self, grid, values, durations, candidates, pending, complete):
        return int(candidates[0])
