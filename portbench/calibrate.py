"""The readings the correctness limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--calls 6] [--fault unchanged|half|answer]

In one process, for each seed: the cell's set-up and warm-up, then
``--calls`` window calls through the timed path (as many as a run
compares), the program's compared numbers (``check.judge``), and for the
control seeds also the control's (``check.control``: the reference in
TF32 in the program's place, on the same calls).  One JSON line a seed,
then the lower readings (the largest the program gave) and the upper
ones (the smallest the control gave).  With ``--fault`` the program runs
with that fault planted (``faults.py``) and the lines are the fault's
readings at the cell's size.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=6)
    ap.add_argument("--fault", default="")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import cell as cellmod
    from portbench import faults, harness

    c = cellmod.load_cell(a.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from spearmint_tpu_torch.ops import build

    build.build_all()
    ctl_seeds = {int(s) for s in a.control_seeds.split(",") if s}
    undo = faults.plant(a.fault) if a.fault else None
    lower, upper = {}, {}
    try:
        for s in (int(s) for s in a.seeds.split(",")):
            out = harness.run_cell(c, s, 0.0, False, "cuda", [],
                                   calls_only=a.calls,
                                   with_control=s in ctl_seeds)
            got = {k: v["value"] for k, v in out["checks"].items()}
            line = {"workload": a.workload, "seed": s, "fault": a.fault,
                    "program": got, "correct": out["correct"],
                    "suggest_s": out["metrics"]["suggest_s"]["value"],
                    "failed": out["failed"]}
            for k, v in got.items():
                lower[k] = max(lower.get(k, 0.0), v)
            if "control" in out:
                line.update(control=out["control"], check_s=out["check_s"],
                            diag=out["diag"])
                for k, v in out["control"].items():
                    upper[k] = min(upper.get(k, float("inf")), v)
            print(json.dumps(line), flush=True)
    finally:
        if undo:
            undo()
    print(json.dumps({"workload": a.workload, "fault": a.fault,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
