"""B1, ``shifted_logdet_q``: log det(M + diag d) and rᵀ(M + diag d)⁻¹r
of k lanes (the marginal likelihood of every slice evaluation).
Needs the Cholesky factor (n³/3) and one forward substitution (n²);
reads M [n, n], d [n] and r [n], writes two numbers a lane."""

from portbench.peaks import F32


def ops(k, n, block=128):
    return k * (n ** 3 / 3 + n ** 2)


def bytes_moved(k, n, block=128):
    return F32 * k * (n * n + 2 * n + 2)
