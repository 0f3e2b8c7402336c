"""B5, ``cr_logdet_q``: log det and quadratic form of a block-tridiagonal
matrix of m = n / block diagonal blocks (band mode's joint move).  What
a block factorization needs, per block: its Cholesky (b³/3), the
off-diagonal block against it (b³), the update of the next diagonal block
(b³), and 2b² for the vector; reads the m diagonal and m − 1 off-diagonal
[b, b] blocks and r [n], writes two numbers a lane."""

from portbench.peaks import F32


def ops(k, n, block=128):
    m = -(-n // block)
    return k * m * (7 * block ** 3 / 3 + 2 * block ** 2)


def bytes_moved(k, n, block=128):
    m = -(-n // block)
    return F32 * k * ((2 * m - 1) * block * block + n + 2)
