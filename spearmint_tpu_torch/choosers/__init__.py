"""Chooser registry.

JAX counterpart: ``spearmint_tpu/choosers/__init__.py``.  Same protocol:
every chooser module exposes ``init(expt_dir, arg_string) -> chooser``.
The port holds the two GP-EI choosers and the constrained one so far; the
others are still to port (ROADMAP A7, A9).
"""

from __future__ import annotations

import importlib

_KNOWN = ("GPEIOptChooser", "GPEIChooser", "GPConstrainedEIChooser")


def get_chooser(name: str, expt_dir: str, arg_string: str = ""):
    """Resolve a chooser module by name and initialize it."""
    if name not in _KNOWN:
        raise ValueError(f"unknown chooser {name!r}; known: {_KNOWN}")
    module = importlib.import_module(f"spearmint_tpu_torch.choosers.{name}")
    return module.init(expt_dir, arg_string)
