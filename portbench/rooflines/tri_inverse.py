"""B3, ``tri_inverse``: L⁻¹ of a lower-triangular L (the explicit inverse
of a posterior cache).  n³/3 operations; reads L [n, n], writes L⁻¹
[n, n]."""

from portbench.peaks import F32


def ops(k, n, block=128):
    return k * n ** 3 / 3


def bytes_moved(k, n, block=128):
    return F32 * k * 2 * n * n
