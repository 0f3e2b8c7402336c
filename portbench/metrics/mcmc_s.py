"""Suggestion step (``engine/suggest.py``, ``engine/per_sec.py``): the
device span of the ``stage:mcmc`` range, per profiled suggestion."""

from portbench.metrics import seconds, spans


def read(view):
    got = [seconds(spans(k["trace"], "stage:mcmc")) for k in view.profiled]
    if not got or not all(got):
        return None
    return sum(got) / len(got)
