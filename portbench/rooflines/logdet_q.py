"""B4a, ``logdet_q``: log det K and rᵀK⁻¹r of an assembled K, no shift
(the constraint GP's marginal).  n³/3 + n² operations; reads K [n, n] and
r [n], writes two numbers a lane."""

from portbench.peaks import F32


def ops(k, n, block=128):
    return k * (n ** 3 / 3 + n ** 2)


def bytes_moved(k, n, block=128):
    return F32 * k * (n * n + n + 2)
