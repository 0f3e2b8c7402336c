"""Profiler traces of a suggestion (the choosers' ``profile_dir``).

JAX counterpart: the ``jax.profiler.trace(profile_dir)`` around each
suggestion in ``spearmint_tpu/choosers/GPEIOptChooser.py``.  Here a
suggestion's step runs under ``torch.profiler.profile`` (the CPU, and the
card when the step runs there), the device is synchronized inside the
session, and one Chrome trace is written per call.  Its ranges play the
part of the JAX package's name stack: ``stage:<name>`` over each stage of
the step (``engine/suggest._stage``) and each kernel wrapper's own name
over its call (``ops/gp_kernels.ranged``).

A range's device events are the kernels, copies and sets launched inside
it, which the trace draws under a ``gpu_user_annotation`` of the range
(linked to its launches by correlation id, not by the host's clock).  A
trace that lost the device events of a kernel wrapper's launches is
refused (``check``): it raises, it is never kept as if it were whole.

The profiler drops device events as out of its window in two ways,
measured on an H100 (``chip_smoke.py --profiler-skew`` and the
``profile_dir`` phase).  About every 10 s, in every process of the
machine at once, the device's timestamps as it maps them onto the host
clock run up to 5.6 ms early, so the events just after the session opens
seem to precede it: a profiled step idles ``MARGIN_S`` after the session
opens and again before it closes.  And in a process that has profiled
before, a session can lose its first k device records (k up to 29 in
``chip_smoke.py``'s run, more than a short session's 14 B1 records): a
profiled step first launches ``LEAD_IN`` records of its own
(``lead_in``), which take that loss, and ``check`` refuses a trace in
which none of them is left.
"""

from __future__ import annotations

import bisect
import json
import os

# The kernel wrappers (ops/gp_kernels, ops/band), each a range of its name.
KERNEL_RANGES = ("shifted_logdet_q", "shifted_factor_logdet_q", "logdet_q",
                 "factor_logdet_q", "tri_inverse", "cr_logdet_q")
STAGE_PREFIX = "stage:"
# Idle seconds at each end of a profiled step on the card: about 10× the
# largest early skew of the device's timestamps measured on an H100.
MARGIN_S = 0.05
# Device records a profiled step launches first, in the range LEAD_IN_RANGE,
# to take the loss of a session's first records: about 9× the most lost in
# a session measured on an H100 (29), for about 1 ms of launches.
LEAD_IN = 256
LEAD_IN_RANGE = "trace:lead_in"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def lead_in(device) -> None:
    """``LEAD_IN`` one-element device kernels in the range ``LEAD_IN_RANGE``
    (their values are never read)."""
    import torch

    with torch.profiler.record_function(LEAD_IN_RANGE):
        t = torch.empty(1, device=device)
        for _ in range(LEAD_IN):
            t.add_(1.0)


def kernel_launches() -> dict[str, int]:
    """The kernel wrappers' launch counters, by wrapper name."""
    from spearmint_tpu_torch.ops import band, gp_kernels

    return {**gp_kernels.launches, **band.launches}


def load(path: str) -> list[dict]:
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def ranges(events: list[dict], prefix_or_names) -> dict[str, list[int]]:
    """{range name: [device events of each occurrence]} for the ranges
    (``user_annotation`` events) whose name is in ``prefix_or_names`` (a
    tuple of names) or starts with it (a string).  An occurrence's device
    events are those inside its ``gpu_user_annotation`` (same External
    id): the span the profiler draws, on the device's own clock, over the
    kernels, copies and sets launched inside the range and not inside a
    range nested in it."""
    def wanted(name):
        if isinstance(prefix_or_names, str):
            return name.startswith(prefix_or_names)
        return name in prefix_or_names

    device: dict[tuple, list] = {}      # (device, stream) → sorted starts
    for e in events:
        if e.get("cat") in _DEVICE_CATS:
            device.setdefault((e.get("pid"), e.get("tid")), []).append(
                e["ts"])
    for starts in device.values():
        starts.sort()
    spans = {e.get("args", {}).get("External id"): e for e in events
             if e.get("cat") == "gpu_user_annotation"}
    out: dict[str, list[int]] = {}
    for e in events:
        if e.get("cat") != "user_annotation" or not wanted(e.get("name", "")):
            continue
        span = spans.get(e.get("args", {}).get("External id"))
        n = 0
        if span is not None:
            starts = device.get((span.get("pid"), span.get("tid")), [])
            t0, t1 = span["ts"], span["ts"] + span.get("dur", 0)
            n = bisect.bisect_right(starts, t1) - bisect.bisect_left(starts,
                                                                     t0)
        out.setdefault(e["name"], []).append(n)
    return out


def check(path: str, launched: dict[str, int],
          with_lead_in: bool = False) -> dict[str, list[int]]:
    """The kernel ranges of the trace at ``path`` against ``launched`` (the
    launches the traced call counted, by wrapper): raises unless each
    wrapper that launched shows exactly that many ranges, each holding at
    least one device event, and, ``with_lead_in``, unless a record of the
    lead-in is left (else the step's own first records may be lost).
    Returns the ranges, the lead-in's among them."""
    events = load(path)
    got = ranges(events, KERNEL_RANGES + (LEAD_IN_RANGE,))
    if with_lead_in and max(got.get(LEAD_IN_RANGE, [0])) < 1:
        raise RuntimeError(
            f"{os.path.basename(path)}: all {LEAD_IN} lead-in records were "
            "dropped, so the step's first device events may be: the "
            "profiler lost the call's device events")
    for name, n in launched.items():
        if n and (len(got.get(name, ())) != n or min(got[name]) < 1):
            raise RuntimeError(
                f"{os.path.basename(path)}: {name} launched {n} times but "
                f"the trace holds {len(got.get(name, ()))} ranges with "
                f"{got.get(name, [])} device events: the profiler lost the "
                "call's device events")
    return got
