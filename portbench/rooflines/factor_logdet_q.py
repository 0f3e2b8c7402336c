"""B4b, ``factor_logdet_q``: B4a and the factor L.  n³/3 + n²
operations; reads K [n, n] and r [n], writes L [n, n] and two numbers a
lane."""

from portbench.peaks import F32


def ops(k, n, block=128):
    return k * (n ** 3 / 3 + n ** 2)


def bytes_moved(k, n, block=128):
    return F32 * k * (2 * n * n + n + 2)
