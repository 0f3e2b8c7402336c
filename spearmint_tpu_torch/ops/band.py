"""Band mode of the joint slice move: one band reduction per move, then
banded evaluations — with kernel B5, block cyclic reduction.

JAX counterpart: ``spearmint_tpu/ops/band.py``.  The joint (mean, amp2,
noise) move evaluates the GP log marginal of K = amp2·M + diag(dadd) about
14 times per move against a FIXED unit covariance M.  Dense, each
evaluation is an O(n³) factorization (kernel B1).  Here:

  1. ``reduce_to_band`` — ONE two-sided blocked Householder reduction per
     move, QᵀMQ = T block-tridiagonal with b×b blocks: ``torch.geqrf``
     panels and compact-WY updates, all GEMMs;
  2. per evaluation, (ld, q) of amp2·T + diag(dadd) in O(n·b²): by the
     sequential block scan ``band_logdet_q`` at pads ≤ 2048, by cyclic
     reduction (``cr_logdet_q``, kernel B5) above (``use_cr``).

Why diag(dadd) survives the congruence: dadd is constant on real rows and
on padded rows, and ``unit_cov_matrix`` zeroes the padded rows and columns
of M exactly.  With the mask contiguous (real observations first, as every
caller pads), each panel column has exact zeros at padded positions, so
every reflector that touches a real coordinate has zero padded components,
a reflector of an all-zero padded column acts on padded coordinates only
(τ = 0 or a sign flip), and Qᵀdiag(dadd)Q = diag(dadd) exactly.  So the
padded tail of Qᵀ[y, mask] is exactly 0.

The reduction runs in float64 (``band_reduce``) and hands float32 blocks
to the evaluators.  In float32 its backward error, about c·ε·‖M‖ with ‖M‖
in the thousands at n = 5000, reaches the jitter floor of M's spectrum
(6.2e-4 at pad 5120): on an H100, at the flagship's data with ls 1.2, the
float32 reduction moved M's eigenvalues by up to 9.0e-4, left T
indefinite (least eigenvalue −3.9e-4) and lp 2.2 nats off float64, where
the float64 one, rounded to float32 for the evaluation, kept T positive
semidefinite and lp within 0.013 nats (``chip_smoke.py
--band-precision``).  The JAX package reduces in float32.

Everything is batched over a leading chains axis K (the JAX package vmaps
one chain).  Left out of the JAX module on purpose: ``_householder_qr_scan``
(a fallback for a missing geqrf; ``torch.geqrf`` always exists),
``_chol_small`` and ``_tri_inv_small`` (the MXU's nilpotent-squaring
inverse; B5 inverts by 2×2 block recursion instead), ``cr_eval``'s
batching rule (the batch axis is explicit) and the ``CR_PALLAS`` /
``_cr_pallas_fits`` gates (on the card B5 always runs).  One decision differs: the JAX factory takes
cyclic reduction from pad 2048, where ``_effective_jitter`` adds no
conditioning floor yet; here from pad 2560 (``use_cr``: pad > 2048).

B5 (``csrc/cyclic_reduction.cu``) launches for a CUDA tensor; its plain
version ``cr_logdet_q_ref``, on the kernel's own schedule (each odd block
padded to a 128-wide tile, factored with the pivot d2·rsqrt(d2) and
inverted as B1's diagonal tile is, G = L⁻¹[B_left | B_rightᵀ] and
g = L⁻¹r_odd by products with that inverse, the even-row updates; the
inert padding blocks past ``n_real`` skipped), serves CPU tensors.
``launches`` counts kernel launches (CUDA only); each call is a profiler
range named ``cr_logdet_q``.
"""

from __future__ import annotations

import torch

from spearmint_tpu_torch.core import linalg
from spearmint_tpu_torch.core.likelihood import unit_cov_matrix
from spearmint_tpu_torch.ops import gp_kernels

# Pads above this evaluate by cyclic reduction (B5), the others by the scan.
CR_ABOVE = 2048
# The largest block width B5 takes (each block is factored and inverted as
# one 128-wide tile in shared memory).
CR_MAX_BLOCK = 128

launches = {"cr_logdet_q": 0}


def reset_launches() -> None:
    launches["cr_logdet_q"] = 0


def use_cr(pad: int) -> bool:
    """Whether the factory evaluates a pad by cyclic reduction."""
    return pad > CR_ABOVE


# ---------------------------------------------------------- the reduction
def _panel_wy(panel: torch.Tensor):
    """QR-factor panels [K, m, b] (m ≥ b); return compact-WY reflectors.

    (r [K, b, b], v [K, m, b], t [K, b, b]) with Q = H_1…H_b = I − V T Vᵀ
    and Qᵀ panel = [R; 0]; V unit-lower-trapezoidal, T upper-triangular.
    Zero-τ columns (LAPACK's convention for already-zero columns, e.g.
    padded observations) are identity reflectors: their T row and column
    are exactly zero.
    """
    k_batch, m, b = panel.shape
    vt, taus = torch.geqrf(panel)
    r = torch.triu(vt[:, :b])
    v = torch.tril(vt, -1) + torch.eye(m, b, dtype=panel.dtype,
                                        device=panel.device)
    # T from the inverse of U = diag(1/τ) + strict-upper(VᵀV) (the larft
    # identity); τ = 0 columns are decoupled before and masked after
    live = taus > 0
    tau_safe = torch.where(live, taus, 1.0)
    outer = live[:, :, None] & live[:, None, :]
    u = (torch.where(outer, torch.triu(v.mT @ v, 1), 0.0)
         + torch.diag_embed(1.0 / tau_safe))
    eye = torch.eye(b, dtype=panel.dtype, device=panel.device)
    t = torch.linalg.solve_triangular(u, eye.expand(k_batch, b, b),
                                      upper=True)
    return r, v, torch.where(outer, t, 0.0)


def reduce_to_band(m0: torch.Tensor, vecs: torch.Tensor, block: int = 128):
    """One-stage blocked Householder reduction to bandwidth ``block``.

    m0 [K, N, N] symmetric, padded rows and columns exactly zero (see the
    module docstring), N % block == 0; vecs [K, N, V] columns to transform
    by Qᵀ.  m0 is OVERWRITTEN: its trailing blocks are the workspace, so a
    move holds one [K, N, N] buffer.  Returns

      d_blocks [K, nb, b, b]  diagonal blocks of T = QᵀMQ
      s_blocks [K, nb, b, b]  s_blocks[:, i] is the (i+1, i) block; the
                              last is zero padding
      vecs_t   [K, N, V]      Qᵀ vecs

    Panels k = 0..nb−3 (the last two block rows are within the band): QR
    of the sub-panel below the band, then the block reflector applied
    two-sided to the trailing matrix with three GEMMs — about 2N³ flops a
    lane.
    """
    k_batch, n, _ = m0.shape
    b = block
    if n % b:
        raise ValueError(f"N={n} is not a multiple of block={b}")
    nb = n // b
    d_out, s_out, v_out = [], [], []
    trail, vt = m0, vecs
    for _ in range(max(nb - 2, 0)):
        d_out.append(trail[:, :b, :b])
        r, v, t = _panel_wy(trail[:, b:, :b])
        s_out.append(r)                             # (k+1, k) block = R
        a22 = trail[:, b:, b:]
        y = a22 @ v                                 # [K, m, b]
        tst = t.mT @ ((v.mT @ y) @ t)
        w = y @ t - 0.5 * (v @ tst)                 # [K, m, b]
        a22.baddbmm_(w, v.mT, alpha=-1.0).baddbmm_(v, w.mT, alpha=-1.0)
        trail = a22
        # vectors: Qᵀx = x − V Tᵀ (Vᵀ x)
        tail = vt[:, b:]
        v_out.append(vt[:, :b])
        vt = tail - v @ (t.mT @ (v.mT @ tail))
    rem = trail.shape[1] // b
    for j in range(rem):
        d_out.append(trail[:, j * b:(j + 1) * b, j * b:(j + 1) * b])
        if j + 1 < rem:
            s_out.append(trail[:, (j + 1) * b:(j + 2) * b, j * b:(j + 1) * b])
        v_out.append(vt[:, j * b:(j + 1) * b])
    s_out.append(torch.zeros_like(d_out[0]))
    return torch.stack(d_out, 1), torch.stack(s_out, 1), torch.cat(v_out, 1)


# ------------------------------------------------------ the scan evaluator
def band_logdet_q(d_blocks, s_blocks, amp2, dadd, resid):
    """(Σ log diag L, rᵀK⁻¹r) per lane of K = amp2·T + diag(dadd).

    d_blocks/s_blocks [K, nb, b, b] from ``reduce_to_band``; amp2 [K];
    dadd, resid [K, N] in the reduced basis.  Block-tridiagonal Cholesky as
    nb sequential steps of {b×b library Cholesky, two triangular solves,
    one rank-b update}; a failed factorization gives NaN.
    """
    k_batch, nb, b, _ = d_blocks.shape
    dadd_b = dadd.reshape(k_batch, nb, b)
    r_b = resid.reshape(k_batch, nb, b)
    eye = torch.eye(b, dtype=d_blocks.dtype, device=d_blocks.device)
    a2 = amp2[:, None, None]
    c_prev = torch.zeros_like(d_blocks[:, 0])
    z_prev = torch.zeros_like(r_b[:, 0])
    ld = torch.zeros_like(amp2)
    q = torch.zeros_like(amp2)
    for i in range(nb):
        s = (a2 * d_blocks[:, i] + dadd_b[:, i, None, :] * eye
             - c_prev @ c_prev.mT)
        l_i = linalg.cholesky(s)
        rhs = r_b[:, i] - (c_prev @ z_prev[..., None])[..., 0]
        z_prev = linalg.tri_solve(l_i, rhs[..., None])[..., 0]
        # C_i = amp2·S_i · L_i⁻ᵀ (S_i the (i+1, i) band block)
        c_prev = linalg.tri_solve(l_i, a2 * s_blocks[:, i].mT).mT
        ld = ld + linalg.logdet_from_chol(l_i)
        q = q + (z_prev * z_prev).sum(-1)
    return ld, q


# ------------------------------------------------------ cyclic reduction
def _cr_assemble(d_blocks, s_blocks, amp2, dadd):
    """B5's inputs: a = amp2·D + diag(dadd) and bb = amp2·S, [K, m, b, b]."""
    k_batch, m, b, _ = d_blocks.shape
    eye = torch.eye(b, dtype=d_blocks.dtype, device=d_blocks.device)
    a2 = amp2[:, None, None, None]
    a = a2 * d_blocks + dadd.reshape(k_batch, m, b)[..., None] * eye
    return a, a2 * s_blocks


def _cr_tile_solve(a, v):
    """B5's ``factor_kernel`` step on [G, b, b] blocks and [G, b] vectors:
    the block padded with identity to a CHOL_TILE tile, factored and
    inverted as B1's diagonal tile (``gp_kernels._tile_factor``), then
    g = L⁻¹v.  Returns (Σ log diag L [G], L⁻¹ [G, b, b], g [G, b])."""
    g_count, b, _ = a.shape
    t = gp_kernels.CHOL_TILE
    tile = torch.eye(t, dtype=a.dtype, device=a.device).repeat(g_count, 1, 1)
    tile[:, :b, :b] = a
    lmat, x = gp_kernels._tile_factor(tile)
    vp = torch.zeros(g_count, t, dtype=a.dtype, device=a.device)
    vp[:, :b] = v
    g = (x @ vp[..., None])[:, :b, 0]
    ld = torch.log(torch.diagonal(lmat, dim1=-2, dim2=-1)[:, :b]).sum(-1)
    return ld, x[:, :b, :b], g


def cr_logdet_q_ref(a, bb, r, n_real=None):
    """Plain version of B5: (ld [K], q [K]) of the block-tridiagonal K
    with diagonal blocks a and couplings bb ([K, m, b, b]), r [K, m·b], the
    blocks from ``n_real`` on (default m) inert padding, by the kernel's
    levels.  Each factors and inverts the real odd blocks
    (``_cr_tile_solve``: X = L⁻¹, g = X r_odd), forms G1 = X B_left and
    G2 = X B_rightᵀ, and updates the real even blocks: a_ev −= G1ᵀG1 +
    G2ᵀG2 (of the odd blocks on either side), r_ev −= G1ᵀg + G2ᵀg,
    bb_ev = −G2ᵀG1; then the last block.  Each eliminated block's ld and
    q go to the kernel's slot (level by level, then the last block),
    skipped blocks' slots stay 0, and the slots are summed in order, so
    inert blocks add exactly 0."""
    _check_cr_args(a, bb, r)
    k_batch, m, b, _ = a.shape
    n_real = _check_n_real(n_real, m)
    a, bb = a.clone(), bb.clone()
    r = r.reshape(k_batch, m, b).clone()
    like = dict(dtype=a.dtype, device=a.device)
    pl = torch.zeros(k_batch, m, **like)
    pq = torch.zeros(k_batch, m, **like)
    mc, lvl = m, 0
    while mc > 1:
        h = mc // 2
        nr = (n_real + (1 << lvl) - 1) >> lvl   # real active blocks
        nodd, neven = nr // 2, (nr + 1) // 2
        if nodd:
            i = torch.arange(nodd, device=a.device)
            odd, left = (2 * i + 1) << lvl, (2 * i) << lvl
            even = (2 * torch.arange(neven, device=a.device)) << lvl
            ld_p, x, g = _cr_tile_solve(a[:, odd].reshape(-1, b, b),
                                        r[:, odd].reshape(-1, b))
            x = x.reshape(k_batch, nodd, b, b)
            g = g.reshape(k_batch, nodd, b, 1)
            pl[:, m - mc:m - mc + nodd] = ld_p.reshape(k_batch, nodd)
            pq[:, m - mc:m - mc + nodd] = (g * g).sum((-2, -1))
            g1 = x @ bb[:, left]
            n2 = min(nodd, h - 1)   # the level's last odd row's G2 is unused
            g2 = x[:, :n2] @ bb[:, odd[:n2]].mT
            da = torch.zeros(k_batch, neven, b, b, **like)
            dr = torch.zeros(k_batch, neven, b, **like)
            da[:, :nodd] += g1.mT @ g1
            dr[:, :nodd] += (g1.mT @ g)[..., 0]
            da[:, 1:] += g2[:, :neven - 1].mT @ g2[:, :neven - 1]
            dr[:, 1:] += (g2[:, :neven - 1].mT @ g[:, :neven - 1])[..., 0]
            a[:, even] = a[:, even] - da
            r[:, even] = r[:, even] - dr
            bb[:, even[:n2]] = -(g2.mT @ g1[:, :n2])
        mc, lvl = h, lvl + 1
    ld_p, _, g = _cr_tile_solve(a[:, 0], r[:, 0])
    pl[:, m - 1] = ld_p
    pq[:, m - 1] = (g * g).sum(-1)
    ld = torch.zeros(k_batch, **like)
    q = torch.zeros_like(ld)
    for s in range(m):
        ld = ld + pl[:, s]
        q = q + pq[:, s]
    return ld, q


def _check_n_real(n_real, m):
    if n_real is None:
        return m
    if not 1 <= n_real <= m:
        raise ValueError(f"n_real={n_real}: want 1 ≤ n_real ≤ m={m}")
    return int(n_real)


def cr_workspace_floats(k_batch, m, b):
    """Floats of ``spm_cyclic_reduction``'s workspace: working copies of a,
    bb and r, then X, G1, G2 and g of the odd blocks, then the slots."""
    km, kh = k_batch * m, k_batch * m // 2
    return 2 * km * b * b + km * b + 3 * kh * b * b + kh * b + 2 * km


def _check_cr_args(a, bb, r):
    for name, t in (("a", a), ("bb", bb), ("r", r)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous float32, got "
                             f"{t.dtype}, contiguous={t.is_contiguous()}")
        if t.device != a.device:
            raise ValueError(f"{name} on {t.device}, a on {a.device}")
    if a.ndim != 4 or a.shape[2] != a.shape[3] or bb.shape != a.shape:
        raise ValueError(f"a, bb: want [K, m, b, b], got {tuple(a.shape)}, "
                         f"{tuple(bb.shape)}")
    k_batch, m, b, _ = a.shape
    if m < 2 or m & (m - 1):
        raise ValueError(f"m={m}: want a power of two ≥ 2 (pad with inert "
                         "identity blocks)")
    if b > CR_MAX_BLOCK or b % 4:
        raise ValueError(f"b={b}: want a multiple of 4 ≤ {CR_MAX_BLOCK}")
    if tuple(r.shape) != (k_batch, m * b):
        raise ValueError(f"r: want {(k_batch, m * b)}, got {tuple(r.shape)}")


@gp_kernels.ranged
def cr_logdet_q(a, bb, r, n_real=None):
    """B5: (ld [K], q [K]) of block-tridiagonal K (see ``cr_logdet_q_ref``);
    blocks from ``n_real`` on (default m) are inert padding and are not
    worked on."""
    _check_cr_args(a, bb, r)
    k_batch, m, b, _ = a.shape
    n_real = _check_n_real(n_real, m)
    if not gp_kernels._on_cuda(a):
        return cr_logdet_q_ref(a, bb, r, n_real)
    from spearmint_tpu_torch.ops import build

    ws = torch.empty(cr_workspace_floats(k_batch, m, b), dtype=a.dtype,
                     device=a.device)
    ld = torch.empty(k_batch, dtype=a.dtype, device=a.device)
    q = torch.empty_like(ld)
    p, s = gp_kernels._ptr, gp_kernels._stream
    with torch.cuda.device(a.device):
        err = build.load("cyclic_reduction").spm_cyclic_reduction(
            p(a), p(bb), p(r), p(ws), p(ld), p(q), k_batch, m, b, n_real,
            ws.numel(), s(a))
    gp_kernels._raise_on(err, "spm_cyclic_reduction")
    launches["cr_logdet_q"] += 1
    return ld, q


# ---------------------------------------------------------- the factory
def band_reduce(x, y, mask, ls, kernel, block: int = 128):
    """One move's reduction: M = ``unit_cov_matrix`` of each lane of ls
    [K, D] and vecs = [y·mask, mask], built and reduced in float64, then
    (d_blocks, s_blocks, Qᵀy, Qᵀmask) in x's dtype."""
    k_batch, n = ls.shape[0], x.shape[0]
    vecs = torch.stack([torch.where(mask, y, 0.0), mask.to(x.dtype)], -1)
    d_blocks, s_blocks, vt = reduce_to_band(
        unit_cov_matrix(x.double(), mask, ls.double(), kernel),
        vecs.double().expand(k_batch, n, 2).contiguous(), block)
    d_blocks, s_blocks, vt = (t.to(x.dtype) for t in (d_blocks, s_blocks,
                                                      vt))
    return d_blocks, s_blocks, vt[..., 0], vt[..., 1]


def band_marginal_factory(x, y, mask, ls, kernel, block: int = 128,
                          cr: bool | None = None):
    """Reduce once, return ``marginal(mean [K], amp2 [K], noise [K]) -> lp
    [K]``, the exact GP log marginal (``core/likelihood.log_marginal``'s
    formula, NaN → −inf) of each lane through its banded form (reduced in
    float64 by ``band_reduce``, evaluated in float32).

    x [N, D], y [N], mask [N] (contiguous: real observations first), ls
    [K, D]; N % block == 0.  One reduction per joint move (ls fixed).
    ``cr`` None: cyclic reduction at the pads ``use_cr`` picks, the scan
    at the others; block counts pad to a power of two with inert identity
    blocks (a = I, bb = 0, r = 0) for cyclic reduction.
    """
    if cr is None:
        cr = use_cr(x.shape[0])
    d_blocks, s_blocks, uy, um = band_reduce(x, y, mask, ls, kernel, block)
    mask_use = mask
    n_real = d_blocks.shape[1]
    if cr:
        nb = n_real
        ext = (max(2, 1 << (nb - 1).bit_length()) - nb) * block
        uy = torch.nn.functional.pad(uy, (0, ext))
        um = torch.nn.functional.pad(um, (0, ext))
        mask_use = torch.cat([mask, mask.new_zeros(ext)])
        zb = (0, 0, 0, 0, 0, ext // block)
        d_blocks = torch.nn.functional.pad(d_blocks, zb)
        s_blocks = torch.nn.functional.pad(s_blocks, zb)

    def marginal(mean, amp2, noise):
        dadd = torch.where(mask_use, noise[:, None], 1.0)
        resid = uy - mean[:, None] * um
        if cr:
            a, bb = _cr_assemble(d_blocks, s_blocks, amp2, dadd)
            ld, q = cr_logdet_q(a, bb, resid.contiguous(), n_real)
        else:
            ld, q = band_logdet_q(d_blocks, s_blocks, amp2, dadd, resid)
        lp = -ld - 0.5 * q
        return torch.where(torch.isnan(lp), float("-inf"), lp)

    return marginal
