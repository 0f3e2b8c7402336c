"""B2, ``shifted_factor_logdet_q``: B1's log det and quadratic form, and
the factor L itself (a posterior cache).  Operations as B1; reads M [n, n],
d [n], r [n], writes L [n, n] and two numbers a lane."""

from portbench.peaks import F32


def ops(k, n, block=128):
    return k * (n ** 3 / 3 + n ** 2)


def bytes_moved(k, n, block=128):
    return F32 * k * (2 * n * n + 2 * n + 2)
