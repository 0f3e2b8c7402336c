"""Chooser registry.

JAX counterpart: ``spearmint_tpu/choosers/__init__.py``, with the same
names in the same order.  Same protocol: every chooser module exposes
``init(expt_dir, arg_string) -> chooser`` and the chooser exposes
``next(grid, values, durations, candidates, pending, complete)`` returning
either an int grid index or a ``(value, new_point)`` tuple for an
off-grid invention.  The GP choosers run on their ``device`` argument;
Random, Sequential, Grid and RandomForestEI are numpy (and scikit-learn)
on the host.
"""

from __future__ import annotations

import importlib

_KNOWN = (
    "GPEIOptChooser",
    "GPEIperSecChooser",
    "GPEIChooser",
    "GPConstrainedEIChooser",
    "RandomChooser",
    "SequentialChooser",
    "GridChooser",
    "RandomForestEIChooser",
)


def get_chooser(name: str, expt_dir: str, arg_string: str = ""):
    """Resolve a chooser module by name and initialize it."""
    if name not in _KNOWN:
        raise ValueError(f"unknown chooser {name!r}; known: {_KNOWN}")
    module = importlib.import_module(f"spearmint_tpu_torch.choosers.{name}")
    return module.init(expt_dir, arg_string)
