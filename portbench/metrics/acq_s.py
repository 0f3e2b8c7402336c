"""Suggestion step: the acquisition's device spans, ``stage:caches`` +
``stage:ei`` + ``stage:lbfgs``, per profiled suggestion."""

from portbench.metrics import seconds, spans

STAGES = ("stage:caches", "stage:ei", "stage:lbfgs")


def read(view):
    got = [sum(seconds(spans(k["trace"], s)) for s in STAGES)
           for k in view.profiled]
    if not got or not all(got):
        return None
    return sum(got) / len(got)
