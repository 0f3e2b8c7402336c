"""What one profiled suggestion's Chrome trace says, reduced once.

The chooser's ``profile_dir`` writes one ``torch.profiler`` trace per
``next``.  Its ranges are the program's: ``stage:<name>`` over each stage
of the suggestion step and one range per kernel-wrapper call, named after
the wrapper (``shifted_logdet_q`` is B1).  The profiler draws each range a
second time on the device, as a ``gpu_user_annotation`` linked to the host
range by its ``External id``, spanning the device events launched inside
it; device events are ``kernel``, ``gpu_memcpy`` and ``gpu_memset``.  This
is the arithmetic of the program's own trace reader, copied so that the
yardstick does not move with the program.

``reduce_trace`` keeps, for one suggestion:
  * ``window``: from the start of ``stage:mcmc`` on the host to the later
    of the end of ``stage:lbfgs`` and the last device event, in µs (the
    profiler's idle margins and lead-in lie outside it);
  * the device events inside the window, and their union (``busy_us``);
  * the device spans of every stage and wrapper range;
  * the idle gaps of the window, each labelled with what the host was in:
    the innermost range and the innermost host operation at its middle.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
STAGE_PREFIX = "stage:"
LEAD_IN_RANGE = "trace:lead_in"
NAME_CHARS = 160


class StepTrace(NamedTuple):
    window: tuple            # (t0, t1) µs
    busy_us: float
    device: list             # [(t0, t1, name)] inside the window, sorted
    spans: dict              # range name → [(t0, t1)] device spans
    gaps: list               # [(µs, label)]


def load(path: str) -> list:
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def union(intervals) -> float:
    """Length of the union of (t0, t1) intervals."""
    total, end = 0.0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def merged(intervals) -> list:
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def inside(t0, t1, spans) -> bool:
    return any(a <= t0 and t1 <= b for a, b in spans)


def device_spans(events) -> dict:
    """Range name → device spans, a range's host annotation linked to its
    ``gpu_user_annotation`` by External id (ranges without device events
    have none)."""
    gpu = {e.get("args", {}).get("External id"): e for e in events
           if e.get("cat") == "gpu_user_annotation"}
    out = defaultdict(list)
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        g = gpu.get(e.get("args", {}).get("External id"))
        if g is not None:
            out[e["name"]].append((g["ts"], g["ts"] + g.get("dur", 0)))
    return dict(out)


def _host(events, cats):
    return sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""))
                  for e in events if e.get("cat") in cats)


def _innermost(sorted_iv, starts, t, scan=512):
    """Name of the latest-starting interval that holds t (the innermost
    of properly nested ones), or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        if sorted_iv[j][1] >= t:
            return sorted_iv[j][2]
    return None


def reduce_trace(events) -> StepTrace:
    host_ranges = _host(events, ("user_annotation",))
    mcmc = [r for r in host_ranges if r[2] == STAGE_PREFIX + "mcmc"]
    lbfgs = [r for r in host_ranges if r[2] == STAGE_PREFIX + "lbfgs"]
    if not mcmc:
        raise ValueError("trace holds no stage:mcmc range")
    t0 = mcmc[0][0]
    spans = device_spans(events)
    lead = spans.get(LEAD_IN_RANGE, [])
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0),
                  e.get("name", "")[:NAME_CHARS]) for e in events
                 if e.get("cat") in DEVICE_CATS)
    dev = [d for d in dev if not inside(d[0], d[1], lead)]
    after = [d for d in dev if d[1] > t0]
    t1 = max([r[1] for r in lbfgs] + [d[1] for d in after] + [t0])
    inwin = [(max(a, t0), min(b, t1), n) for a, b, n in after if a < t1]
    busy = merged((a, b) for a, b, _ in inwin)
    gaps_iv, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps_iv.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps_iv.append((cur, t1))
    ranges = [r for r in host_ranges if r[2] != LEAD_IN_RANGE]
    r_starts = [r[0] for r in ranges]
    ops = _host(events, HOST_OP_CATS)
    o_starts = [o[0] for o in ops]
    gaps = []
    for a, b in gaps_iv:
        mid = 0.5 * (a + b)
        where = _innermost(ranges, r_starts, mid) or "step"
        op = _innermost(ops, o_starts, mid) or "python"
        gaps.append((b - a, f"{where} | {op}"[:NAME_CHARS]))
    return StepTrace((t0, t1), sum(b - a for a, b in busy), inwin, spans,
                     gaps)


def read_step(path: str) -> StepTrace:
    return reduce_trace(load(path))


def breakdown(steps, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps (summed by what the host was in), in seconds, over ``steps``."""
    ops, gaps = defaultdict(float), defaultdict(float)
    for st in steps:
        for a, b, name in st.device:
            ops[name] += (b - a) * 1e-6
        for us, label in st.gaps:
            gaps[label] += us * 1e-6

    def head(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": head(ops), "idle_gaps": head(gaps)}
