"""The plain reference of a GP-EI suggestion, in PyTorch, and its control.

What a suggestion of ``GPEIOptChooser`` / ``GPEIperSecChooser`` derives
from its inputs and its hyperparameter samples, worked out again from the
math (the golden copy, ``reference/golden.py``), sample by sample and
without padding:

    K      = amp2·(k52(X, X) + jitter·I) + noise·I,  L = chol(K)
    lp     = −Σ log diag L − ½ rᵀK⁻¹r,  r = y − mean
    mu(c)  = mean + k(X, c)ᵀ K⁻¹ r,   var(c) = amp2·(1 + jitter) − ‖L⁻¹k(X, c)‖²
    EI(c)  = σ (u Φ(u) + φ(u)),  u = (min y − mu)/σ,  σ = √max(var, 1e-14)
    EI/s   = EI / max(exp(mu_time(c)), 1e-3)   (the duration GP's mean)

The acquisition is returned as its logarithm, in float64 from the
moments (``log_expected_improvement``): at thousands of observations EI
spans many orders of magnitude, and where the incumbent lies tens of
posterior deviations below the posterior (as under objective noise) EI
itself underflows.
The jitter is the model's: 1e-6, plus 2e-7 for every padded row past
2048 (the configuration states float32 at padded sizes; see
``jitter_for``).

``REFERENCE`` computes it in float64 with the library's Cholesky and
triangular solves.  ``CONTROL`` is the same math one precision step below
what the configuration states (float32 with TF32 off): float32 with
PyTorch's TF32 mode on, that is every matrix product in TF32 (operands
rounded to 10 mantissa bits, products accumulated in float32) and the
library's float32 Cholesky, which that mode leaves alone; the solves are
products with an explicit L⁻¹, as the program's posterior is.  The TF32
rounding is done here (``to_tf32``), so the control reads the same on
any device.  (A Cholesky whose trailing updates are TF32 products does
not factor these matrices at all: see ``PERF.md``.)

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

JITTER = 1e-6
MIN_SECONDS = 1e-3
CAND_CHUNK = 4096


def pad_bucket(n: int, minimum: int = 16) -> int:
    """The padded size the configuration runs n observations at: powers of
    two and their quarter midpoints (5000 → 5120)."""
    b = minimum
    while True:
        if n <= b:
            return b
        for num in (5, 6, 7):
            if n <= (b * num) // 4:
                return (b * num) // 4
        b *= 2


def jitter_for(n: int) -> float:
    """The model's diagonal jitter at n observations."""
    return JITTER + 2e-7 * max(0, pad_bucket(n) - 2048)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class Arith(NamedTuple):
    name: str
    dtype: torch.dtype
    tf32: bool             # matrix products in TF32

    def mm(self, a, b):
        if self.tf32:
            return to_tf32(a) @ to_tf32(b)
        return a @ b

    def cholesky(self, a):
        """Lower factor, NaN where the matrix is not positive definite."""
        chol, info = torch.linalg.cholesky_ex(a)
        return chol if int(info) == 0 else torch.full_like(a, math.nan)


REFERENCE = Arith("float64", torch.float64, False)
CONTROL = Arith("tf32", torch.float32, True)


def matern52(x1, x2, ls):
    """Matérn-5/2 of length-scaled points, x1 [n, D], x2 [m, D], ls [D]."""
    r2 = torch.zeros(x1.shape[0], x2.shape[0], dtype=x1.dtype,
                     device=x1.device)
    for d in range(x1.shape[1]):
        diff = x1[:, None, d] / ls[d] - x2[None, :, d] / ls[d]
        r2 += diff * diff
    r = torch.sqrt(r2)
    s5 = math.sqrt(5.0)
    return (1.0 + s5 * r + (5.0 / 3.0) * r2) * torch.exp(-s5 * r)


class Factor(NamedTuple):
    lp: float
    chol: torch.Tensor
    alpha: torch.Tensor
    linv: torch.Tensor | None


def factor(x, y, mean, amp2, noise, ls, arith: Arith, jitter: float,
           with_inverse: bool = False) -> Factor:
    """One sample's factorization and log marginal (without −n/2·log 2π)."""
    n = x.shape[0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    k = amp2 * (matern52(x, x, ls) + jitter * eye) + noise * eye
    chol = arith.cholesky(k)
    del k
    r = (y - mean)[:, None]
    linv = None
    if arith.tf32:
        # the solves as products with L⁻¹, the explicit inverse
        linv = torch.linalg.solve_triangular(chol, eye, upper=False)
        w = arith.mm(linv, r)
        alpha = arith.mm(linv.mT, w)[:, 0]
    else:
        w = torch.linalg.solve_triangular(chol, r, upper=False)
        alpha = torch.linalg.solve_triangular(chol.mT, w, upper=True)[:, 0]
        if with_inverse:
            linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    lp = float(-torch.log(torch.diagonal(chol)).sum() - 0.5 * (w * w).sum())
    return Factor(lp if math.isfinite(lp) else -math.inf, chol, alpha, linv)


def posterior(f: Factor, x, pts, mean, amp2, ls, arith: Arith,
              jitter: float, with_var: bool = True):
    """Posterior mean and variance at pts [m, D]."""
    kx = amp2 * matern52(x, pts, ls)
    mu = mean + arith.mm(f.alpha[None, :], kx)[0]
    if not with_var:
        return mu, None
    if f.linv is not None:
        beta = arith.mm(f.linv, kx)
    else:
        beta = torch.linalg.solve_triangular(f.chol, kx, upper=False)
    return mu, amp2 * (1.0 + jitter) - (beta * beta).sum(0)


def log_expected_improvement(mu, var, best):
    """ln EI in float64, finite however far below the incumbent the
    posterior lies: EI = σ φ(u) (1 + u √(π/2) erfcx(−u/√2)) for u < 0,
    where φ(u) and Φ(u) underflow long before EI's logarithm does."""
    mu, var = mu.to(torch.float64), var.to(torch.float64)
    sigma = torch.sqrt(torch.clamp_min(var, 1e-14))
    u = (best - mu) / sigma
    neg = torch.clamp_max(u, 0.0)
    tail = (torch.log1p(neg * math.sqrt(math.pi / 2)
                        * torch.special.erfcx(-neg / math.sqrt(2.0)))
            - 0.5 * neg * neg - 0.5 * math.log(2.0 * math.pi))
    pos = torch.clamp_min(u, 0.0)
    head = torch.log(pos * torch.special.ndtr(pos)
                     + torch.exp(-0.5 * pos * pos) / math.sqrt(2 * math.pi))
    return torch.log(sigma) + torch.where(u < 0, tail, head)


class SampleSet(NamedTuple):
    """Hyperparameter samples of one family, float64 host arrays or
    tensors: mean, amp2, noise [S], ls [S, D]."""
    mean: object
    amp2: object
    noise: object
    ls: object


class Judged(NamedTuple):
    lp: list            # [S] value-GP log marginal of each sample
    lp_time: list       # [S] duration-GP log marginal ([] without)
    acq: torch.Tensor   # [S, m] ln EI (or ln EI/s) of each sample at pts
    ok: torch.Tensor    # [S] both families factored


def acquisition(x, y, pts, samples: SampleSet, arith: Arith, device,
                time_y=None, time_samples: SampleSet | None = None,
                ) -> Judged:
    """Each sample's EI (or, with ``time_y``, EI per expected second) at
    pts [m, D], and its log marginal; x [n, D], y [n] unpadded."""
    dt = arith.dtype

    def put(a):
        return torch.as_tensor(a, dtype=torch.float64).to(device=device,
                                                          dtype=dt)

    x, y, pts = put(x), put(y), put(pts)
    jit = jitter_for(x.shape[0])
    best = y.min()
    s_all = len(samples.mean)
    lps, lps_t, acq, ok = [], [], [], []
    for s in range(s_all):
        h = [put(a)[s] for a in samples]
        f = factor(x, y, *h, arith, jit)
        lps.append(f.lp)
        good = math.isfinite(f.lp)
        ft = ht = None
        if time_y is not None:
            ty = put(time_y)
            ht = [put(a)[s] for a in time_samples]
            ft = factor(x, ty, *ht, arith, jit, with_inverse=False)
            lps_t.append(ft.lp)
            good = good and math.isfinite(ft.lp)
        row = []
        for i in range(0, pts.shape[0], CAND_CHUNK):
            c = pts[i:i + CAND_CHUNK]
            mu, var = posterior(f, x, c, h[0], h[1], h[3], arith, jit)
            ei = log_expected_improvement(mu, var, best)
            if ft is not None:
                mu_t, _ = posterior(ft, x, c, ht[0], ht[1], ht[3], arith,
                                    jit, with_var=False)
                ei = ei - torch.clamp_min(mu_t.to(torch.float64),
                                          math.log(MIN_SECONDS))
            row.append(ei)
        del f, ft
        acq.append(torch.cat(row))
        ok.append(good and bool(torch.isfinite(acq[-1]).all()))
    return Judged(lps, lps_t, torch.stack(acq),
                  torch.tensor(ok, device=acq[0].device))


def sample_mean(judged: Judged) -> torch.Tensor:
    """ln of the acquisition averaged over the samples that factored."""
    ok = judged.ok
    if not bool(ok.any()):
        return torch.full_like(judged.acq[0], math.nan)
    return (torch.logsumexp(judged.acq[ok], 0)
            - math.log(int(ok.sum())))
