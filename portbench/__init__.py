"""The benchmark of ``spearmint_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``harness.py``
drives the chooser, ``check.py`` decides ``correct`` against the plain
reference in ``reference/``, ``tracing.py`` and ``metrics/`` read the
per-layer metrics, ``rooflines/`` and ``peaks.py`` are the yardstick,
``configs/`` and ``traffic/`` the cells' data, and ``calibrate.py`` the
readings the correctness limits were set from.  Nothing here imports
JAX or the JAX package.
"""
