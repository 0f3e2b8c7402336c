"""One run of one cell: set-up, the measured window, the traced calls,
the check.

The window drives the chooser's public entry, ``next(grid, values,
durations, candidates, pending, complete)``, as the experiment harness
calls it: one client, suggestions back to back, the chooser carrying its
chain state between calls and writing its state file and ``suggest``
event on each.  The experiment directory lives under ``TMPDIR`` and goes
when the run ends.

Set-up is process start up to the window: the kernels' build (a cell's
first run in a checkout only), the inputs from the seed, and one warm-up
``next`` (the configuration's burn-in and a first suggestion, every shape
the window uses).  The window then counts whole suggestions until
``seconds`` have passed.  A traced run adds ``profiled_calls``
suggestions after it through a second chooser on the same experiment
with ``profile_dir`` set, which resumes the state file; their traces give
the per-layer metrics that read the device.

A ``Recorder`` keeps, by reference, what each suggestion step returned
and the log marginals its sampler computed, so that the check can judge
what the timed path produced.  It wraps the step's entry points where
the chooser and the step look them up; it copies and synchronizes
nothing.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

import torch

from portbench import cell as cellmod
from portbench import check, tracing

HERE = os.path.dirname(os.path.abspath(__file__))


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


class Recorder:
    """Keeps each suggestion step's inputs, result and sweeps' log
    marginals (``records``), by reference."""

    def __init__(self):
        self.records: list[dict] = []
        self._current = None
        self._saved = []

    def install(self):
        from spearmint_tpu_torch.engine import per_sec, suggest

        self._wrap(suggest, "sample_hypers_lp", self._sweep)
        self._wrap(suggest, "suggest_step", lambda f: self._step(f, False))
        self._wrap(per_sec, "suggest_step_per_sec",
                   lambda f: self._step(f, True))

    def uninstall(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def _wrap(self, mod, name, make):
        fn = getattr(mod, name)
        self._saved.append((mod, name, fn))
        setattr(mod, name, make(fn))

    def _sweep(self, fn):
        def sweep(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self._current is not None:
                self._current["lps"].append((out[0], out[1]))
            return out
        return sweep

    def _step(self, fn, two_families):
        def step(*args, **kwargs):
            rec = {"h_in": args[1], "t_in": args[2] if two_families else None,
                   "lps": []}
            self._current = rec
            try:
                rec["res"] = fn(*args, **kwargs)
            finally:
                self._current = None
            self.records.append(rec)
            return rec["res"]
        return step


class RunView(NamedTuple):
    """What a per-layer metric's reader may read."""
    config: dict
    traffic: dict
    n: int                 # completed observations
    chains: int
    families: int          # GP families (2 in the cost-aware chooser)
    candidates: int
    window: list           # window calls: wall_s, latency_s, launched
    profiled: list         # profiled calls: the same, and ``trace``


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, found by name."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def power_limit_w():
    """The card's power limit, from ``nvidia-smi`` (None if unreadable)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _suggest_events(expt: str) -> list:
    path = os.path.join(expt, "events.jsonl")
    with open(path) as f:
        events = [json.loads(line) for line in f if line.strip()]
    return [e for e in events if e.get("kind") == "suggest"]


def run_cell(c: cellmod.Cell, seed: int, seconds: float, trace: bool,
             device: str, per_layer: list, calls_only: int = 0,
             with_control: bool = False) -> dict:
    """One run; returns the result line's fields but ``device``'s card
    readings (``run.py`` adds those).  ``calls_only`` > 0 runs that many
    window calls in place of ``seconds``, and ``with_control`` adds the
    control's readings on the same calls (``calibrate.py``)."""
    from spearmint_tpu_torch.utils.trace import kernel_launches

    on_card = device.startswith("cuda")
    inputs = cellmod.make_inputs(c.config, c.traffic, seed)
    name = c.config["chooser"]
    cls = getattr(importlib.import_module(
        f"spearmint_tpu_torch.choosers.{name}"), name)
    args = cellmod.chooser_args(c.config, seed, device)
    expt = tempfile.mkdtemp(prefix="portbench.")
    rec = Recorder()
    calls = []

    def ask(chooser, profiled=False):
        before = kernel_launches()
        n0 = len(rec.records)
        t0 = time.perf_counter()
        ans = chooser.next(inputs.grid, inputs.values, inputs.durations,
                           inputs.candidates, inputs.pending,
                           inputs.complete)
        t1 = time.perf_counter()
        after = kernel_launches()
        if len(rec.records) == n0:
            raise RuntimeError(f"{name}.next returned without a step")
        rec.records[-1]["answer"] = ans
        calls.append({"t1": t1, "wall_s": t1 - t0,
                      "launched": {k: after[k] - before[k] for k in after},
                      "record": len(rec.records) - 1, "profiled": profiled})

    try:
        rec.install()
        chooser = cls(expt, **args)
        ask(chooser)                                   # warm-up
        if on_card:
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        setup_s = process_age()
        while (len(calls) <= calls_only if calls_only else
               time.perf_counter() - t_start < seconds):
            ask(chooser)
        t_end = calls[-1]["t1"]
        n_window = len(calls) - 1
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        steps = []
        if trace:
            prof_dir = os.path.join(expt, "traces")
            traced = cls(expt, **args, profile_dir=prof_dir)
            for _ in range(int(c.traffic["profiled_calls"])):
                ask(traced, profiled=True)
                files = [f for f in os.listdir(prof_dir)
                         if f.endswith(".pt.trace.json")]
                path = os.path.join(prof_dir, files[0])
                steps.append(tracing.read_step(path))
                os.remove(path)
            del traced
            peak = torch.cuda.max_memory_allocated() if on_card else 0
        del chooser
    finally:
        rec.uninstall()
    try:
        events = _suggest_events(expt)
        for call, ev in zip(calls, events):
            call["latency_s"] = float(ev["latency_s"])
            call["n_ok"] = int(ev["n_ok"])
        if on_card:
            torch.cuda.empty_cache()
        measured = calls[1:]
        window_idx = [k["record"] for k in measured]
        t_check = time.perf_counter()
        diag = [] if with_control else None
        numbers = check.judge(rec.records, window_idx, inputs, expt, name,
                              seed, device, diag)
        ctl = (check.control(rec.records, window_idx, inputs, seed, device)
               if with_control else None)
        check_s = time.perf_counter() - t_check
    finally:
        shutil.rmtree(expt, ignore_errors=True)
    limits = c.config["limits"]
    failed = sum(1 for k in measured if k.get("n_ok", 0) == 0)

    if trace:
        for k, st in zip([k for k in calls if k["profiled"]], steps):
            k["trace"] = st
        view = RunView(c.config, c.traffic, int(c.traffic["completed"]),
                       int(c.config["chains"]),
                       len(check.families(rec.records[-1])),
                       int(inputs.candidates.shape[0]),
                       [k for k in measured if not k["profiled"]],
                       [k for k in measured if k["profiled"]])
        metrics = {}
        for m in per_layer:
            value = load_module("metrics", m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {
            "setup_s": {"value": setup_s, "unit": "s"},
            "suggest_s": {"value": (t_end - t_start) / n_window,
                          "unit": "s"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
        }
    out = {"correct": check.verdict(numbers, limits),
           "attempted": len(measured), "failed": failed,
           "metrics": metrics, "memory_peak_bytes": int(peak),
           "checks": {k: {"value": numbers.get(k), "limit": limits[k]}
                      for k in limits}}
    if ctl is not None:
        out["control"] = ctl
        out["check_s"] = check_s
        out["diag"] = diag
    if trace and steps:
        out["busy_s"] = sum(st.busy_us for st in steps) * 1e-6
        out["window_s"] = sum(st.window[1] - st.window[0]
                              for st in steps) * 1e-6
        out["breakdown"] = tracing.breakdown(steps)
    return out
