"""Grid chooser: exhausts the Sobol grid in order.

Copy of ``spearmint_tpu/choosers/GridChooser.py``.

Reference provenance uncertain (SURVEY.md §2 #17 marks GridChooser
``[verify]``); implemented with the only semantics consistent with its
name — identical to SequentialChooser's grid-order walk."""

from __future__ import annotations

from spearmint_tpu_torch.utils.args import unpack_args


def init(expt_dir, arg_string=""):
    return GridChooser(expt_dir, **unpack_args(arg_string))


class GridChooser:
    def __init__(self, expt_dir):
        pass

    def next(self, grid, values, durations, candidates, pending, complete):
        return int(candidates[0])
