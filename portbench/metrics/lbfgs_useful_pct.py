"""Acquisition optimizer (``acquire/optimize.py``): the share of L-BFGS's
iterations that did useful work, in %: 100 × the program's
``lbfgs:useful_iters`` counter over its ``lbfgs:iters`` counter
(``spearmint_tpu_torch/utils/trace.counters``), read from the program's
registry when the reader runs, so over every suggestion of the run.  A
run's useful iterations are the index + 1 of the last iteration in
which a lane not yet done improved; the loop runs all of its iterations
whatever this reads.  None where the program keeps no such counters or
counted no iteration."""


def read(view):
    from spearmint_tpu_torch.utils import trace

    counters = getattr(trace, "counters", None)
    if counters is None:
        return None
    got = counters()
    iters = got.get("lbfgs:iters", 0)
    if not iters:
        return None
    return 100.0 * got.get("lbfgs:useful_iters", 0) / iters
