"""Samplers (``mcmc/slice.py``, ``mcmc/chains.py``): log-marginal
evaluations per suggestion, counted as launches of kernel B1 (one per
lockstep slice evaluation, both GP families), from the program's launch
counters over the window's unprofiled calls."""

from portbench.metrics import B1


def read(view):
    calls = view.window
    if not calls or not any(k["launched"].get(B1, 0) for k in calls):
        return None
    return sum(k["launched"].get(B1, 0) for k in calls) / len(calls)
