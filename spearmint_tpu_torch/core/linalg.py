"""Masked dense linear algebra for padded GP computations.

JAX counterpart: ``spearmint_tpu/core/linalg.py``.  Every array is padded
to a bucket size and carries a boolean mask; padded rows/cols of the unit
covariance are zero and their diagonal addition is 1, so they factor to
identity rows and add exactly 0 to log-determinants and quadratic forms.

The JAX ``custom_vmap`` dispatch points become functions over an explicit
leading batch axis: ``fma_logdet_q``, ``cache_factor`` and
``factor_solve`` take M [K, N, N], amp2 [K], dadd [K, N], resid [K, N].
All three factor the SHIFTED unit matrix M + diag(dadd/amp2) and rescale
analytically — one route for both devices, so the CPU tests run the same
shift, rescale and padding arithmetic as the card; only the op underneath
differs (the CUDA kernel for CUDA tensors, its plain version on the CPU,
``ops/gp_kernels``).
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
    XLA's.  Used only where the JAX package keeps a library Cholesky (the
    small P×P pending factorization, acquire/fantasy.py)."""
    chol, info = torch.linalg.cholesky_ex(k)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def tri_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b (lower-triangular forward substitution)."""
    return torch.linalg.solve_triangular(chol, b, upper=False)


def chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve K x = b given K = L Lᵀ (b: [..., N, R])."""
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def _shift(amp2, dadd):
    return (dadd / amp2[:, None]).contiguous()


def fma_logdet_q(m0, amp2, dadd, resid):
    """(Σ log diag chol(K), rᵀK⁻¹r) per lane for K = amp2·M + diag(dadd).

    chol(amp2·(M + diag(dadd/amp2))) = √amp2·chol(M + diag(dadd/amp2)), so
    Σ log diag = ld̃ + (N/2)·log amp2 and rᵀK⁻¹r = q̃/amp2 (kernel B1).
    """
    n = m0.shape[-1]
    ld_t, q_t = gp_kernels.shifted_logdet_q(m0, _shift(amp2, dadd),
                                            resid.contiguous())
    return ld_t + 0.5 * n * torch.log(amp2), q_t / amp2


def cache_factor(m0, amp2, dadd, resid):
    """(L, L⁻¹, K⁻¹r) per lane for K = amp2·M + diag(dadd).

    Kernel B2 factors the shifted form, B3 inverts L̃; then
    L = √amp2·L̃, L⁻¹ = L̃⁻¹/√amp2, α = L̃⁻ᵀw̃/amp2.  L̃ and L̃⁻¹ are
    rescaled in place (two [K, N, N] buffers fewer at the flagship).
    """
    _, _, l_sh, w_sh = gp_kernels.shifted_factor_logdet_q(
        m0, _shift(amp2, dadd), resid.contiguous())
    linv_sh = gp_kernels.tri_inverse(l_sh)
    alpha = (linv_sh.mT @ w_sh[..., None])[..., 0] / amp2[:, None]
    s = torch.sqrt(amp2)[:, None, None]
    return l_sh.mul_(s), linv_sh.div_(s), alpha


def factor_solve(m0, amp2, dadd, resid):
    """(L, K⁻¹r) per lane — ``cache_factor`` without the inverse; α by one
    backward triangular solve against L̃ (the > 8k-pad memory mode)."""
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
