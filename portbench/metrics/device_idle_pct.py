"""Device (one H100): the share of the profiled suggestions' step time in
which no kernel, copy or set ran, in %: 1 − (union of device events) ÷
(the step's span, ``stage:mcmc``'s start to the step's last work; the
profiler's margins and lead-in excluded)."""


def read(view):
    steps = [k["trace"] for k in view.profiled]
    window = sum(st.window[1] - st.window[0] for st in steps)
    busy = sum(st.busy_us for st in steps)
    if not steps or busy <= 0 or window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
