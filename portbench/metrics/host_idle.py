"""Shared by ``lbfgs_idle_s`` and ``mcmc_idle_s`` (not a metric): the
device's idle seconds while the host was inside one stage's loop, per
profiled suggestion.  ``tracing.reduce_trace`` labels each idle gap of a
profiled step ``<range> | <host op>``, the range being the innermost host
range at the gap's middle; a gap counts here where that range is the
stage's own or one of its loop's ``<layer>:<phase>`` ranges."""


def idle_s(view, stage: str, loop_prefix: str):
    steps = [k["trace"] for k in view.profiled]
    if not steps or not any(st.device for st in steps):
        return None
    total_us = 0.0
    for st in steps:
        for us, label in st.gaps:
            where = label.split(" | ", 1)[0]
            if where == stage or where.startswith(loop_prefix):
                total_us += us
    return total_us * 1e-6 / len(steps)
