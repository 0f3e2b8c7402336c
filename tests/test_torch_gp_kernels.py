"""Plain versions of the Cholesky-family kernels vs the JAX Pallas kernels.

``spearmint_tpu_torch.ops.gp_kernels`` holds B1 (shifted_logdet_q), B2
(shifted_factor_logdet_q), B4a (logdet_q), B4b (factor_logdet_q) and B3
(tri_inverse).  B4a/B4b factor an assembled K; the tests hand them
K = M + diag(d) assembled in float32, the matrix B1/B2 factor through the
shift, and parametrise the shared tests over the two forms.  On a CPU
tensor each
wrapper runs its plain PyTorch version, which follows the CUDA kernel's
blocked schedule (B1-B4b: 256-wide panels, CHOL_PANEL, factored by
128-wide tiles, the diagonal tile by 32-column sub-blocks, ragged last
tile; B3: 2×2 block recursion over 128-wide tiles).  Here those run
against the Pallas kernels in interpret mode at ``block=128, sub=32`` —
as ``tests/test_pallas_gp.py`` runs them — and against float64 numpy.
Tolerances are the Pallas tests' own: ld 2e-4, q 2e-3, L 2e-4, X 3e-4.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as spla
import torch

from spearmint_tpu.ops.pallas_gp import (
    factor_logdet_q_pallas,
    logdet_q_pallas,
    shifted_factor_logdet_q_pallas,
    shifted_logdet_q_pallas,
    tri_inverse_pallas,
)
from spearmint_tpu_torch.core import linalg as tlin
from spearmint_tpu_torch.core.likelihood import (
    _effective_jitter,
    unit_cov_matrix,
)
from spearmint_tpu_torch.ops import gp_kernels as gk

torch.set_num_threads(1)

PALLAS = dict(block=128, sub=32, interpret=True)


def _case(k_batch, n, npad=0, seed=0):
    """M = F Fᵀ/8 (+ padded rows zeroed), shifts in [0.1, 0.4] (1 on padded
    rows), r standard normal (0 on padded rows)."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((k_batch, n, 8)).astype(np.float32)
    m = np.einsum("knd,kmd->knm", f, f) / 8
    d = rng.uniform(0.1, 0.4, (k_batch, n)).astype(np.float32)
    r = rng.standard_normal((k_batch, n)).astype(np.float32)
    if npad:
        mask = np.arange(n) < n - npad
        m = np.where(mask[:, None] & mask[None, :], m, 0.0).astype(np.float32)
        d = np.where(mask, d, 1.0).astype(np.float32)
        r = np.where(mask, r, 0.0).astype(np.float32)
    return m, d, r


def _f64(m, d, r):
    a = m.astype(np.float64) + np.stack([np.diag(x) for x in d])
    chol = np.linalg.cholesky(a)
    w = np.stack([spla.solve_triangular(c, v, lower=True)
                  for c, v in zip(chol, r.astype(np.float64))])
    ld = np.log(np.diagonal(chol, axis1=-2, axis2=-1)).sum(-1)
    return ld, (w * w).sum(-1), chol, w


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _assemble(m, d):
    """K = M + diag(d) in float32 (padded rows: identity rows)."""
    return (m + np.stack([np.diag(x) for x in d])).astype(np.float32)


FORMS = ["shifted", "unshifted"]


def _factor(form, m, d, r):
    """(ld, q, L, w) of M + diag(d): B2 through the shift, or B4b on the
    assembled K."""
    if form == "shifted":
        return gk.shifted_factor_logdet_q(*_t(m, d, r))
    return gk.factor_logdet_q(*_t(_assemble(m, d), r))


def _logdet(form, m, d, r):
    """(ld, q) of M + diag(d): B1, or B4a on the assembled K."""
    if form == "shifted":
        return gk.shifted_logdet_q(*_t(m, d, r))
    return gk.logdet_q(*_t(_assemble(m, d), r))


@pytest.fixture(scope="module", params=[(256, 0), (384, 37), (512, 45)],
                ids=["n256", "n384_pad37", "n512_pad45"])
def pallas_case(request):
    """One Pallas B1, B2, B3, B4a and B4b run per shape, shared by the
    tests."""
    n, npad = request.param
    m, d, r = _case(3, n, npad, seed=n)
    mj, dj, rj = map(jnp.asarray, (m, d, r))
    kj = jnp.asarray(_assemble(m, d))
    ld1, q1 = shifted_logdet_q_pallas(mj, dj, rj, **PALLAS)
    ld2, q2, l2, w2 = shifted_factor_logdet_q_pallas(mj, dj, rj, **PALLAS)
    x3 = tri_inverse_pallas(l2, **PALLAS)
    ld4, q4 = logdet_q_pallas(kj, rj, **PALLAS)
    out = dict(b1=(ld1, q1), b2=(ld2, q2, l2, w2), b3=x3, b4a=(ld4, q4),
               b4b=factor_logdet_q_pallas(kj, rj, **PALLAS))
    return (m, d, r), {k: tuple(np.asarray(a) for a in v)
                       if isinstance(v, tuple) else np.asarray(v)
                       for k, v in out.items()}


def test_b1_plain_matches_pallas(pallas_case):
    (m, d, r), pal = pallas_case
    ld, q = gk.shifted_logdet_q(*_t(m, d, r))
    np.testing.assert_allclose(ld.numpy(), pal["b1"][0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(q.numpy(), pal["b1"][1], rtol=2e-3, atol=2e-3)
    ld0, q0, _, _ = _f64(m, d, r)
    np.testing.assert_allclose(ld.numpy(), ld0, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(q.numpy(), q0, rtol=2e-3, atol=2e-3)


def test_b2_plain_matches_pallas(pallas_case):
    """Same scalars as B1, plus L (exact zeros above the diagonal, where
    Pallas leaves its input) and w = L⁻¹r."""
    (m, d, r), pal = pallas_case
    ld, q, lmat, w = gk.shifted_factor_logdet_q(*_t(m, d, r))
    p_ld, p_q, p_l, p_w = pal["b2"]
    np.testing.assert_allclose(ld.numpy(), p_ld, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(q.numpy(), p_q, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lmat.numpy(), np.tril(p_l), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(w.numpy(), p_w, rtol=2e-3, atol=2e-3)
    assert float(torch.triu(lmat, 1).abs().max()) == 0.0
    _, _, chol0, w0 = _f64(m, d, r)
    np.testing.assert_allclose(lmat.numpy(), chol0, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(w.numpy(), w0, rtol=2e-3, atol=2e-3)


def test_b4a_plain_matches_pallas(pallas_case):
    """B4a on the assembled K against Pallas' unshifted kernel and float64,
    at B1's tolerances."""
    (m, d, r), pal = pallas_case
    ld, q = gk.logdet_q(*_t(_assemble(m, d), r))
    np.testing.assert_allclose(ld.numpy(), pal["b4a"][0], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(q.numpy(), pal["b4a"][1], rtol=2e-3, atol=2e-3)
    ld0, q0, _, _ = _f64(m, d, r)
    np.testing.assert_allclose(ld.numpy(), ld0, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(q.numpy(), q0, rtol=2e-3, atol=2e-3)


def test_b4b_plain_matches_pallas(pallas_case):
    """B4b: B4a's scalars, plus L (exact zeros above the diagonal, where
    Pallas leaves its input) and w, at B2's tolerances."""
    (m, d, r), pal = pallas_case
    ld, q, lmat, w = gk.factor_logdet_q(*_t(_assemble(m, d), r))
    p_ld, p_q, p_l, p_w = pal["b4b"]
    np.testing.assert_allclose(ld.numpy(), p_ld, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(q.numpy(), p_q, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lmat.numpy(), np.tril(p_l), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(w.numpy(), p_w, rtol=2e-3, atol=2e-3)
    assert float(torch.triu(lmat, 1).abs().max()) == 0.0
    _, _, chol0, w0 = _f64(m, d, r)
    np.testing.assert_allclose(lmat.numpy(), chol0, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(w.numpy(), w0, rtol=2e-3, atol=2e-3)


def test_b3_plain_matches_pallas(pallas_case):
    """Both invert the Pallas factor, whose tiles above the block diagonal
    still hold the input: B3 must read only the lower triangle."""
    _, pal = pallas_case
    l_pallas = pal["b2"][2]
    assert np.abs(np.triu(l_pallas, 1)).max() > 0.0
    x = gk.tri_inverse(torch.tensor(l_pallas)).numpy()
    np.testing.assert_allclose(x, pal["b3"], rtol=3e-4, atol=3e-4)
    assert float(np.abs(np.triu(x, 1)).max()) == 0.0
    x0 = np.stack([spla.solve_triangular(np.tril(c).astype(np.float64),
                                         np.eye(c.shape[0]), lower=True)
                   for c in l_pallas])
    np.testing.assert_allclose(x, x0, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("form", FORMS)
def test_nan_lane_is_isolated(form):
    """A non-PSD lane gives NaN (d2·rsqrt(d2) of a negative pivot) in its
    own ld and q only, in the plain versions as in Pallas; the other
    lanes equal a run without the bad lane."""
    m, d, r = _case(3, 200, seed=4)
    m[0] = -m[0]
    ld, q, lmat, w = _factor(form, m, d, r)
    ld1, q1 = _logdet(form, m, d, r)
    for a in (ld, q, ld1, q1):
        assert bool(torch.isnan(a[0])) and bool(torch.isfinite(a[1:]).all())
    assert bool(torch.isfinite(lmat[1:]).all())
    assert bool(torch.isfinite(gk.tri_inverse(lmat)[1:]).all())
    good = _factor(form, m[1:], d[1:], r[1:])
    for a, b in zip((ld, q, lmat, w), good):
        np.testing.assert_array_equal(a[1:].numpy(), b.numpy())
    mp, dp, rp = _case(2, 256, seed=4)
    mp[0] = -mp[0]
    if form == "shifted":
        p_ld, p_q = shifted_logdet_q_pallas(*map(jnp.asarray, (mp, dp, rp)),
                                            **PALLAS)
    else:
        p_ld, p_q = logdet_q_pallas(jnp.asarray(_assemble(mp, dp)),
                                    jnp.asarray(rp), **PALLAS)
    assert np.isnan(np.asarray(p_ld)[0]) and np.isnan(np.asarray(p_q)[0])
    assert np.isfinite(np.asarray(p_ld)[1])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_real,n", [(100, 160), (64, 136), (37, 40),
                                       (130, 256), (100, 288)])
def test_padded_rows_are_inert(n_real, n, form):
    """Rows with M = 0, shift 1 and r = 0 (identity rows of the assembled
    K) factor to identity rows: ld, q of the unpadded problem (1e-6
    relative: the sums run over more terms in another order), L and w
    exactly zero off the real block and L exactly the identity on the
    padded block."""
    m, d, r = _case(2, n, n - n_real, seed=n)
    ld, q, lmat, w = _factor(form, m, d, r)
    s = slice(0, n_real)
    ld0, q0, l0, w0 = _factor(form, np.ascontiguousarray(m[:, s, s]),
                              np.ascontiguousarray(d[:, s]),
                              np.ascontiguousarray(r[:, s]))
    np.testing.assert_allclose(ld.numpy(), ld0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(q.numpy(), q0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(lmat[:, s, s].numpy(), l0.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(w[:, s].numpy(), w0.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert float(lmat[:, n_real:, :n_real].abs().max()) == 0.0
    np.testing.assert_array_equal(lmat[:, n_real:, n_real:].numpy(),
                                  np.broadcast_to(np.eye(n - n_real),
                                                  (2, n - n_real, n - n_real)))
    assert float(w[:, n_real:].abs().max()) == 0.0
    x = gk.tri_inverse(lmat)
    np.testing.assert_array_equal(x[:, n_real:, n_real:].numpy(),
                                  lmat[:, n_real:, n_real:].numpy())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", [16, 20, 28, 56, 64, 65, 100, 136, 200, 127,
                               128, 129, 160, 257])
def test_every_small_pad_factors(n, form):
    """Every ragged width the port produces goes through the same blocked
    schedule: against float64 at 1e-5 (ld) and 1e-4 (q, L, X)."""
    m, d, r = _case(2, n, seed=n)
    ld, q, lmat, w = _factor(form, m, d, r)
    x = gk.tri_inverse(lmat)
    ld0, q0, l0, _ = _f64(m, d, r)
    np.testing.assert_allclose(ld.numpy(), ld0, rtol=1e-5)
    np.testing.assert_allclose(q.numpy(), q0, rtol=1e-4)
    np.testing.assert_allclose(lmat.numpy(), l0, atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.linalg.inv(l0), atol=1e-4)


# B3 at every width the tests above give it, and at five tiles (640: the
# recursion's top level pairs four tiles with one).  Pallas takes whole
# 128-row blocks, so each factor is padded with identity to one (its
# inverse is the padded inverse's leading block); the Pallas results are
# computed once per padded width, every factor of that width a lane.
B3_WIDTHS = [16, 20, 28, 56, 64, 65, 100, 127, 128, 129, 136, 160, 200,
             257, 40, 256, 288, 640]


def _b3_factor(n):
    m, d, r = _case(1, n, seed=100 + n)
    return gk.shifted_factor_logdet_q(*_t(m, d, r))[2][0].numpy()


@functools.cache
def _b3_pallas(npad):
    widths = [n for n in B3_WIDTHS if -(-n // 128) * 128 == npad]
    lanes = np.stack([np.eye(npad, dtype=np.float32) for _ in widths])
    for i, n in enumerate(widths):
        lanes[i, :n, :n] = _b3_factor(n)
    x = np.asarray(tri_inverse_pallas(jnp.asarray(lanes), **PALLAS))
    return {n: x[i, :n, :n] for i, n in enumerate(widths)}


@pytest.mark.parametrize("n", B3_WIDTHS)
def test_b3_plain_matches_pallas_at_every_width(n):
    """B3's plain version (2×2 block recursion over 128-wide tiles) against
    the Pallas kernel in interpret mode at its tests' tolerance (3e-4) and
    against the float64 inverse (1e-4), with junk above the diagonal;
    exact zeros above the diagonal."""
    lmat = _b3_factor(n)
    junk = lmat + np.triu(np.full_like(lmat, 5.0), 1)
    x = gk.tri_inverse(torch.tensor(junk[None]))[0].numpy()
    np.testing.assert_allclose(x, _b3_pallas(-(-n // 128) * 128)[n],
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(
        x, np.linalg.inv(lmat.astype(np.float64)), atol=1e-4)
    assert float(np.abs(np.triu(x, 1)).max()) == 0.0


def test_c3_unshifted_factor_is_as_precise_as_the_reference(record_property):
    """ROADMAP C3: is B4a's lp at the constraint GP's states further from
    float64 than the reference's?  Constraint-like K (``unit_cov_matrix``
    of uniform points in D = 2 at pad 1024, per-lane ls 0.15..1, amp2 = 1,
    no noise term, padded rows identity) with the constrained preset's
    jitter, ``_effective_jitter(5000)`` = 6.2e-4: at pad 1024's own 1e-6,
    K rounded to float32 is indefinite in float64 from ls ≈ 0.4, so no lp
    error exists there.  r: draws from the float64 prior, as the latents'
    ESS proposes.  lp = −ld − q/2 against a float64 factorization of the
    same float32 K, for (a) the port's plain version (the kernel's
    schedule: 128-wide diagonal tiles, L_ik through their explicit
    inverse), (b) ``logdet_q_pallas`` in interpret mode at its production
    block for this pad (512, sub 128) and at the tests' block 128, sub 32,
    (c) a float32 library Cholesky.  Each route's RMS, median and largest
    error (over its finite lanes) and its count of NaN lanes go to the
    test's properties (``--junitxml`` writes them out).

    Each lane's error is float32 rounding noise that varies several-fold
    from lane to lane and schedule to schedule, so ten lanes are compared
    by their root-mean-square.  Pinned: (a) is finite in every lane and
    its RMS lp error is at most twice that of (b) at block 128, sub 32
    (the factor by which the port's kernels' lp errors have been
    compared with each other at the constraint states); the reference
    at its production block is NaN where (a) is finite (its 128-wide
    sub-blocks are inverted by nilpotent squaring, which overflows at
    these condition numbers, 1.9e5-1.4e6)."""
    pad, n, k = 1024, 1000, 10
    rng = np.random.RandomState(0)
    x = np.zeros((pad, 2), np.float32)
    x[:n] = rng.rand(n, 2)
    mask = torch.tensor(np.arange(pad) < n)
    ls = torch.linspace(0.15, 1.0, k)[:, None].expand(k, 2).contiguous()
    m = unit_cov_matrix(torch.tensor(x), mask, ls)
    m += torch.diag_embed(
        (_effective_jitter(5000) - _effective_jitter(pad)) * mask.float())
    kmat = (m + torch.diag_embed(torch.where(mask, 0.0, 1.0))).contiguous()
    l64 = torch.linalg.cholesky(kmat.double())
    r = torch.where(mask, (l64 @ torch.tensor(rng.randn(k, pad, 1)))[..., 0],
                    0.0).float().contiguous()
    w64 = torch.linalg.solve_triangular(l64, r.double()[..., None],
                                        upper=False)[..., 0]
    lp64 = (-torch.log(torch.diagonal(l64, dim1=-2, dim2=-1)).sum(-1)
            - 0.5 * (w64 * w64).sum(-1)).numpy()

    def err(ld, q):
        lp = -np.asarray(ld, np.float64) - 0.5 * np.asarray(q, np.float64)
        return np.abs(lp - lp64)

    port = err(*gk.logdet_q(kmat, r))
    kj, rj = jnp.asarray(kmat.numpy()), jnp.asarray(r.numpy())
    ref_prod = err(*logdet_q_pallas(kj, rj, interpret=True))
    ref_test = err(*logdet_q_pallas(kj, rj, **PALLAS))
    lib_l = torch.linalg.cholesky_ex(kmat)[0]
    lib_w = torch.linalg.solve_triangular(lib_l, r[..., None],
                                          upper=False)[..., 0]
    lib = err(torch.log(torch.diagonal(lib_l, dim1=-2, dim2=-1)).sum(-1),
              (lib_w * lib_w).sum(-1))
    for name, e in (("port", port), ("pallas_512_128", ref_prod),
                    ("pallas_128_32", ref_test), ("library_f32", lib)):
        f = e[np.isfinite(e)]
        record_property(f"c3_{name}", {
            "rms": float(np.sqrt(np.mean(f ** 2))) if f.size else None,
            "median": float(np.median(f)) if f.size else None,
            "max": float(f.max()) if f.size else None,
            "nan_lanes": int((~np.isfinite(e)).sum())})
    assert np.isfinite(port).all() and np.isfinite(ref_test).all()
    assert np.sqrt(np.mean(port ** 2)) <= 2.0 * np.sqrt(np.mean(ref_test ** 2))
    assert np.isnan(ref_prod).any()


def test_shifted_rescale_matches_assembled_form():
    """linalg's one route for both devices at ``kernel_ok`` pads — factor
    M + diag(dadd/amp2), rescale by amp2 — against float64 on the assembled
    K = amp2·M + diag(dadd), padded rows included.  Tolerances of the JAX
    package's shifted-kernel tests: ld 2e-4, q 2e-3, √amp2·L̃ 2e-3/2e-4, α
    2e-2/2e-3 (α is K⁻¹r, amplified by the condition number)."""
    rng = np.random.default_rng(5)
    k_batch, n, npad = 3, 512, 21
    assert tlin.kernel_ok(n)
    f = rng.standard_normal((k_batch, n, 8)).astype(np.float32)
    m0 = np.einsum("knd,kmd->knm", f, f) / 8 + 1e-3 * np.eye(n)
    mask = np.arange(n) < n - npad
    m0 = np.where(mask[:, None] & mask[None, :], m0, 0.0).astype(np.float32)
    amp2 = rng.uniform(0.5, 2.0, k_batch).astype(np.float32)
    noise = rng.uniform(0.1, 0.5, k_batch).astype(np.float32)
    dadd = np.where(mask, noise[:, None], 1.0).astype(np.float32)
    r = np.where(mask, rng.standard_normal((k_batch, n)), 0.0).astype(
        np.float32)
    km = amp2[:, None, None] * m0.astype(np.float64) + np.stack(
        [np.diag(x) for x in dadd])
    ld0, q0, chol0, _ = _f64(km, np.zeros_like(dadd), r)
    args = _t(m0, amp2, dadd, r)
    ld, q = tlin.fma_logdet_q(*args)
    np.testing.assert_allclose(ld.numpy(), ld0, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(q.numpy(), q0, rtol=2e-3, atol=2e-3)
    chol, linv, alpha = tlin.cache_factor(*args)
    np.testing.assert_allclose(chol.numpy(), chol0, rtol=2e-3, atol=2e-4)
    alpha0 = np.stack([spla.cho_solve((c, True), v)
                       for c, v in zip(chol0, r.astype(np.float64))])
    np.testing.assert_allclose(alpha.numpy(), alpha0, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(
        linv.numpy(), np.linalg.inv(chol0), rtol=2e-3, atol=2e-4)


def test_cpu_tensors_take_the_plain_version_uncounted():
    """On the CPU a wrapper returns its plain version's result and never
    counts a launch (only CUDA launches count)."""
    m, d, r = _case(2, 70, seed=9)
    before = dict(gk.launches)
    args = _t(m, d, r)
    for a, b in zip(gk.shifted_logdet_q(*args),
                    gk.shifted_logdet_q_ref(*args)):
        assert torch.equal(a, b)
    out = gk.shifted_factor_logdet_q(*args)
    for a, b in zip(out, gk.shifted_factor_logdet_q_ref(*args)):
        assert torch.equal(a, b)
    assert torch.equal(gk.tri_inverse(out[2]), gk.tri_inverse_ref(out[2]))
    k = torch.tensor(_assemble(m, d))
    for a, b in zip(gk.logdet_q(k, args[2]), gk.logdet_q_ref(k, args[2])):
        assert torch.equal(a, b)
    for a, b in zip(gk.factor_logdet_q(k, args[2]),
                    gk.factor_logdet_q_ref(k, args[2])):
        assert torch.equal(a, b)
    assert gk.launches == before
    # the inputs are not modified
    np.testing.assert_array_equal(args[0].numpy(), m)


def test_wrappers_reject_what_the_kernels_do_not_take():
    m, d, r = _t(*_case(2, 32, seed=1))
    with pytest.raises(ValueError):
        gk.shifted_logdet_q(m.double(), d, r)
    with pytest.raises(ValueError):
        gk.shifted_factor_logdet_q(m.transpose(1, 2), d, r)
    with pytest.raises(ValueError):
        gk.shifted_logdet_q(m, d[:, :16].contiguous(), r)
    with pytest.raises(ValueError):
        gk.tri_inverse(m[:, :, :16].contiguous())
    with pytest.raises(ValueError):
        gk.tri_inverse(m.to("meta"))
    with pytest.raises(ValueError):
        gk.logdet_q(m.double(), r)
    with pytest.raises(ValueError):
        gk.factor_logdet_q(m, r[:, :16].contiguous())
    with pytest.raises(ValueError):
        gk.logdet_q(m.transpose(1, 2), r)
