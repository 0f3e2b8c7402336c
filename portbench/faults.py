"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_portbench_faults.py`` on the CPU, ``calibrate.py
--fault`` on the card at the cell's size).  Each replaces one entry of
the program where the step looks it up, and returns a function that puts
it back:

  * ``unchanged``: the sampler's sweep returns its chain states as it got
    them;
  * ``half``: the sample average is taken over the first half of the
    samples;
  * ``answer``: the step's chosen candidate is its worst of the first ten
    and its refined point is moved to the box's opposite corner, where
    they are produced.

A cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations


def _swap(targets):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for mod, name, make in targets:
        setattr(mod, name, make(getattr(mod, name)))

    def undo():
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)
    return undo


def _unchanged(fn):
    return lambda gen, h, lp, *a, **k: (h, lp)


def _half(mean):
    def half(samples, ok, reduce=None):
        k = samples.shape[0] // 2
        return mean(samples[:k], ok[:k], reduce)
    return half


def _answer(step):
    import torch

    def call(*a, **k):
        res = step(*a, **k)
        acq = res.ei_per_s if hasattr(res, "ei_per_s") else res.ei
        worst = torch.argmin(acq[:10])
        return res._replace(best_cand=worst, best_cand_ei=acq[worst],
                            x_opt=1.0 - res.x_opt)
    return call


def plant(name: str):
    from spearmint_tpu_torch.engine import per_sec, suggest

    return _swap({
        "unchanged": [(suggest, "sample_hypers_lp", _unchanged)],
        "half": [(suggest, "nan_robust_mean", _half),
                 (per_sec, "nan_robust_mean", _half)],
        "answer": [(suggest, "suggest_step", _answer),
                   (per_sec, "suggest_step_per_sec", _answer)],
    }[name])


FAULTS = ("unchanged", "half", "answer")
