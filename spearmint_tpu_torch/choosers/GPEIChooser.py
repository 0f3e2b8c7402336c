"""GP-EI chooser, grid-only (no off-grid optimization).

JAX counterpart: ``spearmint_tpu/choosers/GPEIChooser.py``: the flagship's
machinery with ``optimize`` off — the suggestion is the EI argmax over the
given candidates.
"""

from __future__ import annotations

from spearmint_tpu_torch.choosers.GPEIOptChooser import GPEIOptChooser
from spearmint_tpu_torch.utils.args import unpack_args


def init(expt_dir, arg_string=""):
    return GPEIChooser(expt_dir, **unpack_args(arg_string))


class GPEIChooser(GPEIOptChooser):
    def __init__(self, expt_dir, **kwargs):
        super().__init__(expt_dir, **kwargs)
        self.optimize = False
