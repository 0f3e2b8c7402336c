"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``spearmint_tpu_torch``.  Prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compared, beside its limit (also the last lines of standard error).

Exits non-zero with no result when no CUDA card is present (or fewer
than the cell asks for), when the program cannot be imported, and when
JAX, flax or the JAX package is loaded in this process once the window
has closed.  The CUDA kernels build into the checkout
(``spearmint_tpu_torch/ops/_build/``) on a cell's first run there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "spearmint_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from portbench import cell as cellmod

    c = cellmod.load_cell(a.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"portbench: {a.workload} needs {c.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats()
    from portbench import harness
    from spearmint_tpu_torch.ops import build

    build.build_all()
    manifest = cellmod.load_manifest(ROOT)
    kind = "per_layer" if a.trace else "end_to_end"
    metrics = [m for m in manifest[kind]
               if a.workload in m.get("workloads", [a.workload])]
    out = harness.run_cell(c, a.seed, a.seconds, bool(a.trace), "cuda",
                           metrics)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": c.chips,
              "memory_peak_bytes": out.pop("memory_peak_bytes"),
              "power_limit_w": harness.power_limit_w()}
    if a.trace:
        device["busy_s"] = out.pop("busy_s")
        device["window_s"] = out.pop("window_s")
    checks = out.pop("checks")
    line = {**out, "device": device, "checks": checks}
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
