"""Marginal likelihood (``core/likelihood.py``, ``core/linalg.py``):
device time inside the ``stage:mcmc`` span and outside every kernel
wrapper's range, over the B1 launches there, in ms per evaluation: the
covariance assembly (and the sampler's small element-wise work) that
every slice evaluation pays beside its factorization."""

from portbench.metrics import B1, WRAPPERS, spans
from portbench.tracing import inside, union


def read(view):
    total_us, evals = 0.0, 0
    for k in view.profiled:
        st = k["trace"]
        mcmc = spans(st, "stage:mcmc")
        wrapped = [s for w in WRAPPERS for s in spans(st, w)]
        b1 = [s for s in spans(st, B1) if inside(s[0], s[1], mcmc)]
        own = [(a, b) for a, b, _ in st.device
               if inside(a, b, mcmc) and not inside(a, b, wrapped)]
        total_us += union(own)
        evals += len(b1)
    if not evals:
        return None
    return total_us * 1e-3 / evals
