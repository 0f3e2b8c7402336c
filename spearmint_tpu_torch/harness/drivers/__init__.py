"""Driver registry.

JAX counterpart: ``spearmint_tpu/harness/drivers/__init__.py``.

Parity: reference ``driver/__init__.py`` + ``dispatch.py`` (SURVEY.md §2
#9): name → driver module with ``submit_job(job) -> proc_id`` and
``is_alive(proc_id) -> bool``.
"""

from __future__ import annotations

import importlib

_KNOWN = ("local", "sge", "fake")


def get_driver(name: str):
    if name not in _KNOWN:
        raise ValueError(f"unknown driver {name!r}; known: {_KNOWN}")
    module = importlib.import_module(
        f"spearmint_tpu_torch.harness.drivers.{name}")
    return module.init()
