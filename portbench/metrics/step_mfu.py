"""Device: the whole suggestion's share of the card's float32 peak, in %:
the operations the step needs at the real n over its step time (the
profiled calls' windows) at 67 TFLOP/s.  A change that takes a kernel
off the path (B1 fused with the covariance assembly, or the work moved
to another wrapper) leaves that kernel's roofline silent; this share
still reads the whole step's gain or loss.  Counted: every kernel-wrapper
call in the trace at its roofline module's operations (chains as lanes),
and the acquisition over the candidates, n²·C per sample for L⁻¹k(X, c)
and 2·n·C per sample and family for the posterior mean.  Not counted:
L-BFGS's evaluations (the program counts none) and the covariance
assembly (element-wise, about 1% of B1's operations), so the share reads
low by those."""

from portbench import peaks
from portbench.harness import load_module
from portbench.metrics import WRAPPERS, spans


def read(view):
    steps = [k["trace"] for k in view.profiled]
    window = sum(st.window[1] - st.window[0] for st in steps) * 1e-6
    if not steps or window <= 0 or not any(st.device for st in steps):
        return None
    k, n, c = view.chains, view.n, view.candidates
    ops = 0.0
    for st in steps:
        for w in WRAPPERS:
            calls = len(spans(st, w))
            if calls:
                ops += calls * load_module("rooflines", w).ops(k, n)
        ops += k * (n * n * c + 2 * n * c * view.families)
    return 100.0 * ops / (window * peaks.F32_FLOPS)
