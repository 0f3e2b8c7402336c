"""The per-layer metrics, one reader a metric, each found by its name in
``BENCHMARK.json``: ``read(view)`` takes a ``harness.RunView`` of a
traced run and returns the number, or None where the run holds nothing
to read (no device events, no profiled call).  A reader never returns 0
for a share of a roofline or a peak it could not read."""

B1 = "shifted_logdet_q"
# Every kernel wrapper whose calls the traces hold as ranges (B1-B5).
WRAPPERS = ("shifted_logdet_q", "shifted_factor_logdet_q", "logdet_q",
            "factor_logdet_q", "tri_inverse", "cr_logdet_q")


def spans(step, name):
    """Device spans (µs) of a range in one profiled call's trace."""
    return step.spans.get(name, [])


def seconds(intervals):
    return sum(b - a for a, b in intervals) * 1e-6
