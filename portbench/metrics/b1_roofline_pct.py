"""Kernels (``ops/gp_kernels.py``, ``ops/csrc/shifted_chol.cu``): B1's
share of its roofline, in %: the least time the card needs for its work
at the real n (``rooflines/shifted_logdet_q.py``: the larger of the
operations at 67 TFLOP/s float32 and the bytes at 3.35 TB/s, over the
chains as lanes) over the device span of each B1 call, summed over the
profiled suggestions."""

from portbench import peaks
from portbench.harness import load_module
from portbench.metrics import B1, seconds, spans


def read(view):
    calls = [s for k in view.profiled for s in spans(k["trace"], B1)]
    if not calls:
        return None
    r = load_module("rooflines", B1)
    k, n = view.chains, view.n
    need = peaks.bound_s(r.ops(k, n), r.bytes_moved(k, n))
    return 100.0 * need * len(calls) / seconds(calls)
