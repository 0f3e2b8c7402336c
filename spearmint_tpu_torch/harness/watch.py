"""Rich terminal status view over the experiment dir + events.jsonl.

The reference's observability is stdout prints and an optional web
status page (SURVEY.md §5.5); the rebuild's structured JSONL event log
(utils/events.py) enables a live top-style view: status counts,
best-so-far, suggestion-latency statistics (the north-star metric,
BASELINE.md) with a sparkline, and the recent event tail.

Copy of ``spearmint_tpu/harness/watch.py`` on the port's
``ExperimentGrid`` and event log: the same snapshot and the same view.

Usage:
    python -m spearmint_tpu_torch.harness.watch EXPT_DIR [--interval S]
        [--once]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from spearmint_tpu_torch.store.experiment import STATE_NAMES, ExperimentGrid
from spearmint_tpu_torch.utils.events import EventLog

SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, width=40) -> str:
    if not values:
        return ""
    vals = list(values)[-width:]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(SPARK[int((v - lo) / span * (len(SPARK) - 1))]
                   for v in vals)


def snapshot(expt_dir: str) -> dict:
    grid = ExperimentGrid(expt_dir)
    counts = {name: int(np.sum(grid.status == i))
              for i, name in enumerate(STATE_NAMES)}
    best_val, best_id = grid.get_best()
    events = EventLog(expt_dir).read()
    suggests = [e for e in events if e.get("kind") == "suggest"]
    bests = [e for e in events if e.get("kind") == "best"]
    return {
        "expt_dir": expt_dir,
        "counts": counts,
        "best_value": None if best_id < 0 else float(best_val),
        "best_job": int(best_id),
        "best_params": None if best_id < 0 else grid.unit_to_list(best_id),
        "latencies": [e["latency_s"] for e in suggests
                      if "latency_s" in e],
        "best_trace": [e["value"] for e in bests if "value" in e],
        "tail": events[-8:],
    }


def _fmt_event(e: dict) -> str:
    ts = time.strftime("%H:%M:%S", time.localtime(e.get("t", 0)))
    kind = e.get("kind", "?")
    rest = {k: v for k, v in e.items() if k not in ("t", "kind")}
    body = " ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in list(rest.items())[:6]
    )
    return f"  {ts}  {kind:<9s} {body}"


def render(snap: dict) -> str:
    lines = [f"spearmint-tpu experiment — {snap['expt_dir']}"]
    counts = snap["counts"]
    total = sum(counts.values())
    lines.append(
        "  " + "   ".join(f"{k}: {v}" for k, v in counts.items())
        + f"   (grid {total})"
    )
    if snap["best_value"] is not None:
        params = ", ".join(f"{p:.5g}" if isinstance(p, float) else str(p)
                           for p in snap["best_params"])
        lines.append(f"  best: {snap['best_value']:.6g}  "
                     f"(job {snap['best_job']}, params [{params}])")
    else:
        lines.append("  best: —")
    lat = snap["latencies"]
    if lat:
        arr = np.asarray(lat)
        lines.append(
            f"  suggest latency: last {arr[-1]:.3f}s  "
            f"median {np.median(arr):.3f}s  p90 "
            f"{np.percentile(arr, 90):.3f}s  n={len(arr)}"
        )
        lines.append(f"    {sparkline(lat)}")
    if snap["best_trace"]:
        lines.append(f"  best trace:  {sparkline(snap['best_trace'])}  "
                     f"({snap['best_trace'][0]:.4g} → "
                     f"{snap['best_trace'][-1]:.4g})")
    if snap["tail"]:
        lines.append("  recent events:")
        lines.extend(_fmt_event(e) for e in snap["tail"])
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spearmint-tpu-status")
    p.add_argument("expt_dir")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit")
    options = p.parse_args(argv)
    expt_dir = os.path.realpath(options.expt_dir)

    if options.once:
        print(render(snapshot(expt_dir)))
        return 0
    try:
        while True:
            out = render(snapshot(expt_dir))
            # clear screen + home; single write to avoid flicker
            print("\x1b[H\x1b[2J" + out
                  + f"\n\n  (refreshing every {options.interval:g}s — "
                    "ctrl-c to exit)", flush=True)
            time.sleep(options.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
