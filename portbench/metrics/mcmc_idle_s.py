"""Samplers (``mcmc/slice.py``): seconds the device idled while the host
drove the slice sampler's loop, per profiled suggestion: the idle gaps
whose innermost host range is ``stage:mcmc`` or one of its
``slice:eval`` and ``slice:read`` ranges (a program without those ranges
labels the same gaps ``stage:mcmc``).  A gap inside a kernel wrapper's
range (B1's launch) is the kernel layer's, not counted here."""

from portbench.metrics.host_idle import idle_s


def read(view):
    return idle_s(view, "stage:mcmc", "slice:")
