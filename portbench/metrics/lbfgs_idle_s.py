"""Acquisition optimizer (``acquire/optimize.py``): seconds the device
idled while the host drove L-BFGS's loop, per profiled suggestion: the
idle gaps whose innermost host range is ``stage:lbfgs`` or one of its
``lbfgs:ladder``, ``lbfgs:grad`` and ``lbfgs:update`` ranges (a program
without those ranges labels the same gaps ``stage:lbfgs``)."""

from portbench.metrics.host_idle import idle_s


def read(view):
    return idle_s(view, "stage:lbfgs", "lbfgs:")
