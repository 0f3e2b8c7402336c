"""Masked dense linear algebra for padded GP computations.

JAX counterpart: ``spearmint_tpu/core/linalg.py``.  Every array is padded
to a bucket size and carries a boolean mask; padded rows/cols of the unit
covariance are zero and their diagonal addition is 1, so they factor to
identity rows and add exactly 0 to log-determinants and quadratic forms.

The JAX ``custom_vmap`` dispatch points become functions over an explicit
leading batch axis: ``fma_logdet_q``, ``cache_factor`` and
``factor_solve`` take M [K, N, N], amp2 [K], dadd [K, N], resid [K, N];
``chol_logdet_q`` takes an assembled K [K, N, N].  Each makes the JAX
package's size dispatch, ``kernel_ok(N)``, on both devices:

  * N ≥ 512 and a multiple of 128: the blocked kernels (``ops/gp_kernels``;
    the CUDA kernel for a CUDA tensor, its plain version on the CPU).  The
    three M-form points factor the SHIFTED unit matrix M + diag(dadd/amp2)
    and rescale analytically, so the CPU runs the same shift, rescale and
    padding arithmetic as the card;
  * below that, the JAX package's XLA sequence on the assembled K: a
    Cholesky, then triangular solves (and L⁻¹ by a solve against I).  The
    blocked float32 factorization gives NaN from cond ≈ 1e8, where an
    unblocked one does not, and small pads reach that conditioning (no
    ``_effective_jitter`` floor below n = 2048).  The Cholesky
    (``small_cholesky``) is the library's (cuSOLVER) for a CUDA tensor.
    On the CPU it is the column sweep ``gp_kernels.column_cholesky``
    instead: MKL's changes its blocking with N, so its results at pad 16
    and at pad 32 differ in the last digits, where the sweep gives the
    masked computation at any pad the bits of the unpadded one.
"""

from __future__ import annotations

import torch

from spearmint_tpu_torch.ops import gp_kernels


def pad_bucket(n: int, minimum: int = 16) -> int:
    """Static-shape bucket for n observations: powers of two plus their
    quarter midpoints (16, 20, 24, 28, 32, 40, ...); n=5000 pads to 5120.
    Identical to the JAX package, so both compute the same shapes."""
    b = minimum
    while True:
        if n <= b:
            return b
        for num in (5, 6, 7):
            if n <= (b * num) // 4:
                return (b * num) // 4
        b *= 2


def pend_pad(obs_pad: int, p: int, minimum: int = 4) -> int:
    """Static pad for P pending points: a multiple of 128 when the
    observation pad is ≥ 512 and 128-aligned, else the bucket ladder."""
    if p > 0 and obs_pad >= 512 and obs_pad % 128 == 0:
        return -(-p // 128) * 128
    return max(minimum, pad_bucket(max(p, 1), minimum=minimum))


def mask_psd_matrix(k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace padded rows/cols of a PSD matrix [..., N, N] with identity."""
    both = mask[:, None] & mask[None, :]
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    return torch.where(both, k, eye)


def cholesky(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky with NaN (not an exception) on a non-PD input, as
    XLA's.  Used where the JAX package keeps XLA's Cholesky rather than a
    Pallas kernel: the small P×P pending factorization (acquire/fantasy.py),
    in the constraint sweep the ESS prior factor and the amp2 move's unit
    factor (engine/constrained.py), and the band scan's b×b blocks
    (ops/band.py)."""
    chol, info = torch.linalg.cholesky_ex(k)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def masked_cholesky(k: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a masked PSD matrix."""
    return cholesky(mask_psd_matrix(k, mask))


def logdet_from_chol(chol: torch.Tensor) -> torch.Tensor:
    """½ log det K = Σ log diag(L) per lane.  Padded diagonal entries are
    1 → 0."""
    return torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def tri_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b (lower-triangular forward substitution)."""
    return torch.linalg.solve_triangular(chol, b, upper=False)


def chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve K x = b given K = L Lᵀ (b: [..., N, R])."""
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def kernel_ok(n: int) -> bool:
    """The JAX package's kernel gate (``pallas_gp.supported(n,
    on_tpu=True)``): pads ≥ 512 that are multiples of 128 go to the
    blocked kernels, every other size to the small-pad route below."""
    return n >= 512 and n % 128 == 0


def _assemble(m0, amp2, dadd):
    """K = amp2·M + diag(dadd), as the JAX package's XLA route builds it."""
    eye = torch.eye(m0.shape[-1], dtype=m0.dtype, device=m0.device)
    return amp2[:, None, None] * m0 + dadd[:, :, None] * eye


def small_cholesky(k: torch.Tensor) -> torch.Tensor:
    """The small-pad route's lower Cholesky of [K, N, N], NaN in a non-PD
    lane: the library's for a CUDA tensor, the padding-exact column sweep
    on the CPU (module docstring)."""
    if k.is_cuda:
        return cholesky(k)
    return gp_kernels.column_cholesky(k)


def _small_logdet_q(k, resid):
    """cholesky → forward solve → Σ log diag, ‖w‖² (the XLA sequence)."""
    chol = small_cholesky(k)
    w = tri_solve(chol, resid[..., None])[..., 0]
    return logdet_from_chol(chol), (w * w).sum(-1)


def _small_factor(k, resid):
    """(L, K⁻¹r) by the small-pad Cholesky and two triangular solves."""
    chol = small_cholesky(k)
    return chol, chol_solve(chol, resid[..., None])[..., 0]


def chol_logdet_q(k, resid):
    """(Σ log diag chol(K), rᵀK⁻¹r) per lane of an assembled K [K, N, N]
    (padded rows identity, ``mask_psd_matrix``), resid [K, N] — kernel
    B4a at ``kernel_ok`` pads, the constraint-GP length-scale move's
    evaluation."""
    if not kernel_ok(k.shape[-1]):
        return _small_logdet_q(k, resid)
    return gp_kernels.logdet_q(k.contiguous(), resid.contiguous())


def _shift(amp2, dadd):
    return (dadd / amp2[:, None]).contiguous()


def fma_logdet_q(m0, amp2, dadd, resid):
    """(Σ log diag chol(K), rᵀK⁻¹r) per lane for K = amp2·M + diag(dadd).

    At ``kernel_ok`` pads: chol(amp2·(M + diag(dadd/amp2))) =
    √amp2·chol(M + diag(dadd/amp2)), so Σ log diag = ld̃ + (N/2)·log amp2
    and rᵀK⁻¹r = q̃/amp2 (kernel B1).
    """
    n = m0.shape[-1]
    if not kernel_ok(n):
        return _small_logdet_q(_assemble(m0, amp2, dadd), resid)
    ld_t, q_t = gp_kernels.shifted_logdet_q(m0, _shift(amp2, dadd),
                                            resid.contiguous())
    return ld_t + 0.5 * n * torch.log(amp2), q_t / amp2


def cache_factor(m0, amp2, dadd, resid):
    """(L, L⁻¹, K⁻¹r) per lane for K = amp2·M + diag(dadd).

    At ``kernel_ok`` pads kernel B2 factors the shifted form, B3 inverts
    L̃; then L = √amp2·L̃, L⁻¹ = L̃⁻¹/√amp2, α = L̃⁻ᵀw̃/amp2.  L̃ and L̃⁻¹
    are rescaled in place (two [K, N, N] buffers fewer at the flagship).
    """
    if not kernel_ok(m0.shape[-1]):
        chol, alpha = _small_factor(_assemble(m0, amp2, dadd), resid)
        eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
        return chol, tri_solve(chol, eye.expand_as(chol)), alpha
    _, _, l_sh, w_sh = gp_kernels.shifted_factor_logdet_q(
        m0, _shift(amp2, dadd), resid.contiguous())
    linv_sh = gp_kernels.tri_inverse(l_sh)
    alpha = (linv_sh.mT @ w_sh[..., None])[..., 0] / amp2[:, None]
    s = torch.sqrt(amp2)[:, None, None]
    return l_sh.mul_(s), linv_sh.div_(s), alpha


def factor_solve(m0, amp2, dadd, resid):
    """(L, K⁻¹r) per lane — ``cache_factor`` without the inverse; at
    ``kernel_ok`` pads α by one backward triangular solve against L̃ (the
    > 8k-pad memory mode)."""
    if not kernel_ok(m0.shape[-1]):
        return _small_factor(_assemble(m0, amp2, dadd), resid)
    _, _, l_sh, w_sh = gp_kernels.shifted_factor_logdet_q(
        m0, _shift(amp2, dadd), resid.contiguous())
    alpha = torch.linalg.solve_triangular(
        l_sh.mT, w_sh[..., None], upper=True)[..., 0] / amp2[:, None]
    return l_sh.mul_(torch.sqrt(amp2)[:, None, None]), alpha


def masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, float("inf")).amin(-1)


def masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, float("-inf")).amax(-1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)


def masked_std(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Population std over masked entries (matches ``np.std``)."""
    m = mask.to(x.dtype)
    cnt = torch.clamp_min(m.sum(-1), 1.0)
    mu = (x * m).sum(-1) / cnt
    var = (((x - mu[..., None]) ** 2) * m).sum(-1) / cnt
    return torch.sqrt(var)
