"""The Cholesky-family kernels of the GP hot path, and their plain versions.

JAX counterpart: ``spearmint_tpu/ops/pallas_gp.py``.  Five kernels, built
from two sources:

  * B1  ``shifted_logdet_q``        (``shifted_logdet_q_pallas``)
  * B2  ``shifted_factor_logdet_q`` (``shifted_factor_logdet_q_pallas``)
  * B4a ``logdet_q``                (``logdet_q_pallas``)
  * B4b ``factor_logdet_q``         (``factor_logdet_q_pallas``)
  * B3  ``tri_inverse``             (``tri_inverse_pallas``)

B1, B2, B4a and B4b are one CUDA kernel (``csrc/shifted_chol.cu``), with
or without the diagonal shift and the emitted factor, as they are one
Pallas body; B3 is ``csrc/tri_inverse.cu``.  Each wrapper launches its
CUDA kernel for a CUDA tensor, and runs the plain PyTorch version beside
it (``*_ref``) only for a tensor on the CPU.  The plain versions follow
the kernels' own blocked schedules, so the CPU tests exercise the tiling,
the ragged edge and the padded rows that the card runs: B1-B4b over
CHOL_PANEL-wide panels with a CHOL_TILE-wide diagonal tile, factored by
CHOL_SUB-column sub-blocks (pivot d2·rsqrt(d2), each sub-block inverted
beside its factor) and inverted by 2×2 block recursion, the ragged last
tile; B3 over PANEL-wide tiles with a forward-substitution tile inverse.

Inputs and outputs are float32 and contiguous.  B1/B2 take M [K, N, N],
dshift [K, N], r [K, N] and factor M + diag(dshift); B4a/B4b take an
assembled K [K, N, N] and r [K, N].  A non-PSD lane gives NaN in that lane
only; padded rows (M = 0 with shift 1, or identity rows of K, with r = 0)
add exactly 0.  ``launches`` counts kernel launches per wrapper (CUDA
only).
"""

from __future__ import annotations

import ctypes

import torch

# Tile width of B3's schedule (tri_inverse_ref); must equal PANEL in
# csrc/tile_ops.cuh.
PANEL = 64
# The Cholesky schedule of B1-B4b: panel width (the depth of each trailing
# update), diagonal-tile width and its sub-block width; each must equal the
# constant of the same name in csrc/shifted_chol.cu.
CHOL_PANEL = 256
CHOL_TILE = 128
CHOL_SUB = 32

launches = {"shifted_logdet_q": 0, "shifted_factor_logdet_q": 0,
            "logdet_q": 0, "factor_logdet_q": 0, "tri_inverse": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain versions
def column_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Unblocked right-looking Cholesky of [K, b, b] by b column steps
    (lower triangle read, pivot d2·rsqrt(d2): a non-PD lane is NaN, never
    ±inf) — the kernels' diagonal-tile sweep.  Identity rows after the
    real ones stay exactly inert, so the real block's bits do not depend
    on b."""
    a = torch.tril(a)
    for j in range(a.shape[-1]):
        d2 = a[:, j, j]
        inv = torch.rsqrt(d2)
        col = a[:, j + 1:, j] * inv[:, None]
        a[:, j, j] = d2 * inv
        a[:, j + 1:, j] = col
        a[:, j + 1:, j + 1:] -= torch.tril(col[:, :, None] * col[:, None, :])
    return a


def _invert_tile(l: torch.Tensor) -> torch.Tensor:
    """[K, b, b] lower-triangular inverse by row forward substitution."""
    b = l.shape[-1]
    x = torch.zeros_like(l)
    eye = torch.eye(b, dtype=l.dtype, device=l.device)
    for r in range(b):
        s = torch.einsum("km,kmc->kc", l[:, r, :r], x[:, :r, :])
        x[:, r, :] = (eye[r] - s) / l[:, r, r, None]
    return x


def _sub_factor(a: torch.Tensor):
    """[K, s, s], s ≤ CHOL_SUB (lower triangle read): one warp's work on a
    diagonal sub-block.  L by s column steps (pivot d2·rsqrt(d2): a non-PD
    lane is NaN, never ±inf), then Y = L⁻¹ row by row with the pivots'
    rsqrt(d2) as its diagonal: Y[r] = (e_r − L[r, :r] Y[:r]) · rsqrt(d2_r).
    Each step is a few whole-batch operations (the CPU tests and the card
    both pay per operation)."""
    a = torch.tril(a)
    s = a.shape[-1]
    inv = torch.empty(a.shape[:-1], dtype=a.dtype, device=a.device)
    for j in range(s):
        torch.rsqrt(a[:, j, j], out=inv[:, j])
        col = a[:, j:, j] * inv[:, j, None]      # col[0] = d2·rsqrt(d2)
        a[:, j:, j] = col
        a[:, j + 1:, j + 1:].baddbmm_(col[:, 1:, None], col[:, None, 1:],
                                      alpha=-1.0)
    a = torch.tril(a)
    y = torch.zeros_like(a)
    eye = torch.eye(s, dtype=a.dtype, device=a.device)
    for r in range(s):
        e_r = eye[r].expand(a.shape[0], 1, s)
        t = torch.baddbmm(e_r, a[:, r:r + 1, :r], y[:, :r, :], alpha=-1.0)
        torch.mul(t[:, 0], inv[:, r, None], out=y[:, r, :])
    return a, y


def _tile_factor(a: torch.Tensor):
    """(L, L⁻¹) of a [K, b, b] diagonal tile (lower triangle read), as
    ``diag_kernel`` computes them at b = CHOL_TILE: right-looking over
    CHOL_SUB columns (sub-block factor and inverse, the rows below as a
    product with that inverse, the rest updated), then L⁻¹'s off-diagonal
    blocks by 2×2 block recursion, X_BA = −X_BB (L_BA X_AA), pairs first."""
    a = torch.tril(a)
    b = a.shape[-1]
    x = torch.zeros_like(a)
    for c0 in range(0, b, CHOL_SUB):
        c1 = min(c0 + CHOL_SUB, b)
        l, y = _sub_factor(a[:, c0:c1, c0:c1])
        a[:, c0:c1, c0:c1] = l
        x[:, c0:c1, c0:c1] = y
        if c1 < b:
            lr = a[:, c1:, c0:c1] @ y.mT
            a[:, c1:, c0:c1] = lr
            a[:, c1:, c1:].baddbmm_(lr, lr.mT, alpha=-1.0)
    a = torch.tril(a)
    w = CHOL_SUB
    while w < b:
        for lo in range(0, b - w, 2 * w):
            mid, hi = lo + w, min(lo + 2 * w, b)
            t = a[:, mid:hi, lo:mid] @ x[:, lo:mid, lo:mid]
            x[:, mid:hi, lo:mid] = -(x[:, mid:hi, mid:hi] @ t)
        w *= 2
    return a, x


def _tile_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a bᵀ for [K, M, D] and [K, N, D] on whole CHOL_TILE-row tiles, rows
    past M and N zero-filled as the kernels' copies fill them, so a row's
    sums do not depend on how many rows sit beside it (a CPU library picks
    its summation order by shape)."""
    m, n = a.shape[-2], b.shape[-2]
    a = torch.nn.functional.pad(a, (0, 0, 0, -m % CHOL_TILE))
    b = torch.nn.functional.pad(b, (0, 0, 0, -n % CHOL_TILE))
    return (a @ b.mT)[..., :m, :n]


def _factor_ref(m0, dshift, resid):
    """The blocked schedule of B1/B2 (dshift [K, N]) and B4a/B4b (dshift
    None: the diagonal tiles are factored as they are): per CHOL_TILE
    step the diagonal tile (a ragged last one padded with identity, as in
    shared memory), the panel below (L_ik = A_ik L_kk⁻ᵀ, w_i −= L_ik w_k)
    and, in a panel wider than the tile, the panel's remaining columns;
    per CHOL_PANEL step the trailing update."""
    k_batch, n, _ = m0.shape
    a = m0.clone()
    w = resid.clone()
    ld = torch.zeros(k_batch, dtype=m0.dtype, device=m0.device)
    q = torch.zeros_like(ld)
    eye = torch.eye(CHOL_TILE, dtype=m0.dtype, device=m0.device)
    for k0 in range(0, n, CHOL_PANEL):
        k1 = min(k0 + CHOL_PANEL, n)
        for s0 in range(k0, k1, CHOL_TILE):
            s1 = min(s0 + CHOL_TILE, n)
            b = s1 - s0
            tile = eye.repeat(k_batch, 1, 1)
            tile[:, :b, :b] = a[:, s0:s1, s0:s1]
            if dshift is not None:
                tile[:, :b, :b] += torch.diag_embed(dshift[:, s0:s1])
            l, x = _tile_factor(tile)
            wk = torch.zeros(k_batch, CHOL_TILE, dtype=m0.dtype,
                             device=m0.device)
            wk[:, :b] = w[:, s0:s1]
            wk = (x @ wk[..., None])[:, :b, 0]
            l, x = l[:, :b, :b], x[:, :b, :b]
            w[:, s0:s1] = wk
            ld += torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)
            q += (wk * wk).sum(-1)
            a[:, s0:s1, s0:s1] = l
            if s1 < n:
                lp = _tile_mm(a[:, s1:, s0:s1], x)
                a[:, s1:, s0:s1] = lp
                a[:, s0:s1, s1:] = 0.0
                w[:, s1:] -= (lp @ wk[..., None])[..., 0]
                if s1 < k1:
                    a[:, s1:, s1:k1] -= _tile_mm(lp, lp[:, :k1 - s1])
        if k1 < n:
            lp = a[:, k1:, k0:k1]
            a[:, k1:, k1:] -= _tile_mm(lp, lp)
    return ld, q, a, w


def shifted_factor_logdet_q_ref(m0, dshift, resid):
    """Plain version of B2: (ld, q, L, w) for L = chol(M + diag(dshift))."""
    _check_factor_args(m0, dshift, resid)
    return _factor_ref(m0, dshift, resid)


def shifted_logdet_q_ref(m0, dshift, resid):
    """Plain version of B1: (ld, q) only."""
    ld, q, _, _ = shifted_factor_logdet_q_ref(m0, dshift, resid)
    return ld, q


def factor_logdet_q_ref(kmat, resid):
    """Plain version of B4b: (ld, q, L, w) for L = chol(K)."""
    _check_factor_args(kmat, None, resid)
    return _factor_ref(kmat, None, resid)


def logdet_q_ref(kmat, resid):
    """Plain version of B4a: (ld, q) only."""
    ld, q, _, _ = factor_logdet_q_ref(kmat, resid)
    return ld, q


def tri_inverse_ref(lmat):
    """Plain version of B3: X = L⁻¹ by block forward substitution."""
    _check_square(lmat, "lmat")
    n = lmat.shape[-1]
    x = torch.zeros_like(lmat)
    for r0 in range(0, n, PANEL):
        r1 = min(r0 + PANEL, n)
        xii = _invert_tile(torch.tril(lmat[:, r0:r1, r0:r1]))
        x[:, r0:r1, r0:r1] = xii
        if r0 > 0:
            # X_kj = 0 for k < j, so the full product is Σ_{j≤k<i} L_ik X_kj
            acc = lmat[:, r0:r1, :r0] @ x[:, :r0, :r0]
            x[:, r0:r1, :r0] = -(xii @ acc)
    return x


# ------------------------------------------------------------------ checks
def _check_square(t, name):
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous float32, got {t.dtype}, "
                         f"contiguous={t.is_contiguous()}")
    if t.ndim != 3 or t.shape[1] != t.shape[2]:
        raise ValueError(f"{name}: want [K, N, N], got {tuple(t.shape)}")


def _check_factor_args(m0, dshift, resid):
    _check_square(m0, "m0")
    k_batch, n, _ = m0.shape
    for name, t in (("dshift", dshift), ("resid", resid)):
        if t is None:
            continue
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous float32")
        if tuple(t.shape) != (k_batch, n):
            raise ValueError(f"{name}: want {(k_batch, n)}, got "
                             f"{tuple(t.shape)}")
        if t.device != m0.device:
            raise ValueError(f"{name} on {t.device}, m0 on {m0.device}")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# ---------------------------------------------------------------- wrappers
def _shifted_chol(m0, dshift, resid, emit):
    """One ``spm_shifted_chol`` call; dshift None runs it unshifted (B4)."""
    from spearmint_tpu_torch.ops import build

    k_batch, n, _ = m0.shape
    ws = torch.empty_like(m0)
    w = torch.empty_like(resid)
    linv = torch.empty((k_batch, CHOL_TILE, CHOL_TILE), dtype=m0.dtype,
                       device=m0.device)
    ld = torch.empty(k_batch, dtype=m0.dtype, device=m0.device)
    q = torch.empty_like(ld)
    with torch.cuda.device(m0.device):
        err = build.load("shifted_chol").spm_shifted_chol(
            _ptr(m0), None if dshift is None else _ptr(dshift), _ptr(resid), _ptr(ws), _ptr(w),
            _ptr(linv), _ptr(ld), _ptr(q), k_batch, n, int(emit),
            _stream(m0))
    _raise_on(err, "spm_shifted_chol")
    return ld, q, ws, w


def shifted_logdet_q(m0, dshift, resid):
    """B1: (Σ log diag L, ‖L⁻¹r‖²) per lane, L = chol(M + diag(dshift))."""
    _check_factor_args(m0, dshift, resid)
    if not _on_cuda(m0):
        return shifted_logdet_q_ref(m0, dshift, resid)
    ld, q, _, _ = _shifted_chol(m0, dshift, resid, emit=False)
    launches["shifted_logdet_q"] += 1
    return ld, q


def shifted_factor_logdet_q(m0, dshift, resid):
    """B2: (ld, q, L, w = L⁻¹r); L lower-triangular with exact zeros above."""
    _check_factor_args(m0, dshift, resid)
    if not _on_cuda(m0):
        return shifted_factor_logdet_q_ref(m0, dshift, resid)
    out = _shifted_chol(m0, dshift, resid, emit=True)
    launches["shifted_factor_logdet_q"] += 1
    return out


def logdet_q(kmat, resid):
    """B4a: (Σ log diag L, ‖L⁻¹r‖²) per lane, L = chol(K) of an assembled K."""
    _check_factor_args(kmat, None, resid)
    if not _on_cuda(kmat):
        return logdet_q_ref(kmat, resid)
    ld, q, _, _ = _shifted_chol(kmat, None, resid, emit=False)
    launches["logdet_q"] += 1
    return ld, q


def factor_logdet_q(kmat, resid):
    """B4b: (ld, q, L, w = L⁻¹r) of an assembled K; L lower-triangular with
    exact zeros above."""
    _check_factor_args(kmat, None, resid)
    if not _on_cuda(kmat):
        return factor_logdet_q_ref(kmat, resid)
    out = _shifted_chol(kmat, None, resid, emit=True)
    launches["factor_logdet_q"] += 1
    return out


def tri_inverse(lmat):
    """B3: X = L⁻¹ for lower-triangular [K, N, N] (upper part ignored)."""
    _check_square(lmat, "lmat")
    if not _on_cuda(lmat):
        return tri_inverse_ref(lmat)
    from spearmint_tpu_torch.ops import build

    k_batch, n, _ = lmat.shape
    x = torch.empty_like(lmat)
    with torch.cuda.device(lmat.device):
        err = build.load("tri_inverse").spm_tri_inverse(
            _ptr(lmat), _ptr(x), k_batch, n, _stream(lmat))
    _raise_on(err, "spm_tri_inverse")
    launches["tri_inverse"] += 1
    return x
