"""Port vs JAX package: covariance kernels, priors, masked linear algebra,
the shifted-form dispatch points and the GP log-marginal.

The same numpy inputs go through ``spearmint_tpu`` (JAX on the CPU) and
``spearmint_tpu_torch`` (PyTorch on the CPU, where the Cholesky-family
wrappers run their plain versions), and through the float64 oracle
``spearmint_tpu.golden.numpy_ref`` where it has the function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spearmint_tpu.core import kernels as jk
from spearmint_tpu.core import likelihood as jl
from spearmint_tpu.core import linalg as jlin
from spearmint_tpu.core import priors as jp
from spearmint_tpu.golden import numpy_ref
from spearmint_tpu_torch.core import kernels as tk
from spearmint_tpu_torch.core import likelihood as tl
from spearmint_tpu_torch.core import linalg as tlin
from spearmint_tpu_torch.core import priors as tp

torch.set_num_threads(1)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _pad(x, y, pad):
    n, d = x.shape
    xp = np.zeros((pad, d), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    return xp, yp, np.arange(pad) < n


def _hypers(rng, k, d):
    return dict(mean=rng.uniform(-0.3, 0.3, k).astype(np.float32),
                amp2=rng.uniform(0.4, 2.0, k).astype(np.float32),
                noise=rng.uniform(1e-3, 0.1, k).astype(np.float32),
                ls=rng.uniform(0.3, 1.5, (k, d)).astype(np.float32))


def _jax_lane(h, i):
    return jl.GPHypers(*(jnp.asarray(h[f][i]) for f in jl.GPHypers._fields))


def _torch_h(h):
    return tl.GPHypers(*(_t(h[f]) for f in tl.GPHypers._fields))


# ------------------------------------------------------------- kernels
@pytest.mark.parametrize("name", ["Matern52", "Matern32", "SquaredExp"])
def test_kernel_matches_jax_per_lane(name, rng):
    """Batched ls [K, D] gives the JAX kernel of each lane.  Same f32
    operations in the same order: 1e-6 relative."""
    x1, x2 = rng.rand(7, 3), rng.rand(5, 3)
    ls = np.abs(rng.randn(4, 3)) + 0.3
    got = tk.get_kernel(name)(_t(x1), _t(x2), _t(ls)).numpy()
    assert got.shape == (4, 7, 5)
    for i in range(4):
        want = np.asarray(jk.get_kernel(name)(
            jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
            jnp.asarray(ls[i], jnp.float32)))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-7)


def test_matern52_matches_golden(rng):
    """float32 against the float64 oracle: 1e-5 relative."""
    x1, x2 = rng.randn(7, 3), rng.randn(5, 3)
    ls = np.abs(rng.randn(3)) + 0.5
    got = tk.matern52(_t(x1), _t(x2), _t(ls)).numpy()
    np.testing.assert_allclose(got, numpy_ref.matern52(x1, x2, ls),
                               rtol=1e-5, atol=1e-6)


def test_matmul_form_at_wide_inputs_matches_jax(rng):
    """D ≥ 32 takes the ‖a‖²+‖b‖²−2abᵀ form in both packages.  The GEMM
    sums in another order than XLA's, and the expansion cancels ~3
    digits of values up to ~30: 1e-3 absolute."""
    d = tk._MATMUL_MIN_DIM
    assert d == jk._MATMUL_MIN_DIM
    x1, x2 = rng.rand(9, d), rng.rand(4, d)
    ls = np.abs(rng.randn(d)) + 0.5
    got = tk.ard_sqdist(_t(x1), _t(x2), _t(ls)).numpy()
    want = np.asarray(jk.ard_sqdist(jnp.asarray(x1, jnp.float32),
                                    jnp.asarray(x2, jnp.float32),
                                    jnp.asarray(ls, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_kernel_grad_at_zero_distance_is_zero():
    """The double-where sqrt: autograd gives 0, not NaN, at r = 0."""
    x = torch.tensor([[0.3, 0.7]])
    z = x[0].clone().requires_grad_(True)
    k = tk.matern52(z[None], x, torch.ones(2))[0, 0]
    (g,) = torch.autograd.grad(k, z)
    assert torch.isfinite(g).all()
    assert float(g.abs().max()) == 0.0


def test_kernel_registry_matches_jax():
    assert sorted(tk.KERNELS) == sorted(jk.KERNELS)
    assert tk.get_kernel("Matern52") is tk.matern52
    with pytest.raises(ValueError):
        tk.get_kernel("nope")


# -------------------------------------------------------------- priors
def test_priors_match_jax(rng):
    noise = rng.uniform(1e-4, 1.0, 16).astype(np.float32)
    amp2 = rng.uniform(0.05, 5.0, 16).astype(np.float32)
    np.testing.assert_allclose(
        tp.horseshoe_logpdf(_t(noise)).numpy(),
        np.asarray(jp.horseshoe_logpdf(jnp.asarray(noise))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tp.lognormal_amp2_term(_t(amp2)).numpy(),
        np.asarray(jp.lognormal_amp2_term(jnp.asarray(amp2))),
        rtol=1e-6, atol=1e-6)
    ls = np.array([[0.5, 1.9], [0.5, 2.1], [-0.1, 1.0], [2.0, 0.01]],
                  np.float32)
    np.testing.assert_array_equal(
        tp.ls_in_bounds(_t(ls)).numpy(),
        np.asarray(jax.vmap(jp.ls_in_bounds)(jnp.asarray(ls))))
    assert (tp.NOISE_SCALE, tp.AMP2_SCALE, tp.MAX_LS, tp.DEFAULT_NOISE) == (
        jp.NOISE_SCALE, jp.AMP2_SCALE, jp.MAX_LS, jp.DEFAULT_NOISE)


# ------------------------------------------------------ masked linalg
def test_pads_are_identical_to_jax():
    """The port computes the same shapes, so the parity tests compare
    like with like."""
    for n in list(range(1, 600)) + list(range(600, 40000, 97)):
        assert tlin.pad_bucket(n) == jlin.pad_bucket(n), n
        assert tlin.pad_bucket(n, minimum=64) == jlin.pad_bucket(
            n, minimum=64), n
    for obs in (16, 40, 512, 640, 1000, 5120, 10240):
        for p in (0, 1, 3, 64, 128, 129, 300):
            assert tlin.pend_pad(obs, p) == jlin.pend_pad(obs, p), (obs, p)
    assert tlin.pad_bucket(5000) + tlin.pend_pad(5120, 64) == 5248


def test_masked_stats_match_jax(rng):
    x = rng.randn(3, 8).astype(np.float32)
    mask = np.array([True] * 5 + [False] * 3)
    for name in ("masked_mean", "masked_std", "masked_min", "masked_max"):
        got = getattr(tlin, name)(_t(x), torch.tensor(mask)).numpy()
        want = np.asarray(jax.vmap(getattr(jlin, name), (0, None))(
            jnp.asarray(x), jnp.asarray(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


def test_mask_psd_matrix_matches_jax(rng):
    k = rng.randn(2, 6, 6).astype(np.float32)
    mask = np.arange(6) < 4
    got = tlin.mask_psd_matrix(_t(k), torch.tensor(mask)).numpy()
    want = np.asarray(jax.vmap(jlin.mask_psd_matrix, (0, None))(
        jnp.asarray(k), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)


def _dispatch_case(rng, k, n, n_real):
    """The sampler's M-form at n observations padded to n: Matérn-5/2 unit
    covariance with padded rows zeroed, noise shifts on real rows."""
    x = rng.rand(n, 2).astype(np.float32)
    mask = np.arange(n) < n_real
    h = _hypers(rng, k, 2)
    m0 = tl.unit_cov_matrix(_t(x), torch.tensor(mask), _t(h["ls"])).numpy()
    dadd = np.where(mask, h["noise"][:, None], 1.0).astype(np.float32)
    r = np.where(mask, rng.randn(k, n), 0.0).astype(np.float32)
    return m0, h["amp2"], dadd, r


@pytest.mark.parametrize("n,n_real", [(40, 37), (100, 91), (136, 136)])
def test_fma_logdet_q_matches_jax(rng, n, n_real):
    """Shift, rescale and padding arithmetic against the JAX dispatch
    (its CPU route assembles K and factors it with XLA).  Two f32
    factorizations of cond ~1e3 matrices: ld to 1e-5 and q to 1e-4
    relative.  n=100 and 136 leave a ragged last panel."""
    m0, amp2, dadd, r = _dispatch_case(rng, 3, n, n_real)
    ld, q = tlin.fma_logdet_q(_t(m0), _t(amp2), _t(dadd), _t(r))
    ld0, q0 = jax.vmap(jlin.fma_logdet_q)(*map(jnp.asarray,
                                               (m0, amp2, dadd, r)))
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld0), rtol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(q0), rtol=1e-4)


@pytest.mark.parametrize("n,n_real", [(40, 37), (100, 91)])
def test_cache_factor_and_factor_solve_match_jax(rng, n, n_real):
    """(L, L⁻¹, K⁻¹r) and (L, K⁻¹r) against the JAX dispatch.  L to 1e-5
    absolute (entries O(1)); L⁻¹ to 1e-4 and α to 1e-3 of their largest
    entries (both scale with 1/√noise or 1/noise, and the f32 error of an
    inversion with the condition number, here up to ~1e3)."""
    m0, amp2, dadd, r = _dispatch_case(rng, 3, n, n_real)
    args_t = (_t(m0), _t(amp2), _t(dadd), _t(r))
    args_j = tuple(map(jnp.asarray, (m0, amp2, dadd, r)))
    chol, linv, alpha = tlin.cache_factor(*args_t)
    chol0, linv0, alpha0 = jax.vmap(jlin.cache_factor)(*args_j)
    chol2, alpha2 = tlin.factor_solve(*args_t)
    scale = float(np.abs(np.asarray(alpha0)).max())
    np.testing.assert_allclose(chol.numpy(), np.tril(np.asarray(chol0)),
                               atol=1e-5)
    np.testing.assert_allclose(
        linv.numpy(), np.asarray(linv0),
        atol=1e-4 * float(np.abs(np.asarray(linv0)).max()))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha0),
                               atol=1e-3 * scale)
    np.testing.assert_array_equal(chol2.numpy(), chol.numpy())
    np.testing.assert_allclose(alpha2.numpy(), np.asarray(alpha0),
                               atol=1e-3 * scale)
    assert float(torch.triu(chol, 1).abs().max()) == 0.0
    assert float(torch.triu(linv, 1).abs().max()) == 0.0


@pytest.mark.parametrize("n,n_real", [(16, 13), (224, 200), (256, 230)])
def test_small_pads_take_the_xla_route_like_jax(rng, n, n_real):
    """Below ``kernel_ok`` (pads under 512) all four dispatch points run
    the JAX package's XLA sequence on the assembled K — an unblocked
    Cholesky, triangular solves, L⁻¹ by a solve against I — and match the
    JAX dispatch per lane: ld 1e-5 and q 1e-4 relative, L 1e-5 absolute,
    L⁻¹ 1e-4 and α 1e-3 of their largest entries (two float32
    factorizations of cond ~1e3)."""
    m0, amp2, dadd, r = _dispatch_case(rng, 3, n, n_real)
    assert not tlin.kernel_ok(n)
    args_t = (_t(m0), _t(amp2), _t(dadd), _t(r))
    args_j = tuple(map(jnp.asarray, (m0, amp2, dadd, r)))
    kmat = tlin._assemble(*args_t[:3])
    for (ld, q), (ld0, q0) in (
            (tlin.fma_logdet_q(*args_t),
             jax.vmap(jlin.fma_logdet_q)(*args_j)),
            (tlin.chol_logdet_q(kmat, args_t[3]),
             jax.vmap(jlin.chol_logdet_q)(jnp.asarray(kmat.numpy()),
                                          args_j[3]))):
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld0), rtol=1e-5)
        np.testing.assert_allclose(q.numpy(), np.asarray(q0), rtol=1e-4)
    chol, linv, alpha = tlin.cache_factor(*args_t)
    chol0, linv0, alpha0 = jax.vmap(jlin.cache_factor)(*args_j)
    chol2, alpha2 = tlin.factor_solve(*args_t)
    _, alpha3 = jax.vmap(jlin.factor_solve)(*args_j)
    linv0, alpha0 = np.asarray(linv0), np.asarray(alpha0)
    np.testing.assert_allclose(chol.numpy(), np.asarray(chol0), atol=1e-5)
    np.testing.assert_array_equal(chol2.numpy(), chol.numpy())
    np.testing.assert_allclose(linv.numpy(), linv0,
                               atol=1e-4 * np.abs(linv0).max())
    for a, want in ((alpha, alpha0), (alpha2, np.asarray(alpha3))):
        np.testing.assert_allclose(a.numpy(), want,
                                   atol=1e-3 * np.abs(want).max())


def test_kernel_gate_is_the_jax_packages():
    from spearmint_tpu.ops import pallas_gp

    for n in (16, 128, 224, 256, 384, 500, 511, 512, 576, 640, 1000, 1024,
              1280, 2048, 2560, 5120, 5248, 5376, 8192):
        assert tlin.kernel_ok(n) == pallas_gp.supported(n, on_tpu=True), n


# ---------------------------------------------------------- likelihood
def test_effective_jitter_matches_jax():
    for n in (1, 16, 2048, 2049, 5120, 5248, 10240):
        assert tl._effective_jitter(n) == jl._effective_jitter(n)
    assert tl.JITTER == jl.JITTER


def test_covariances_match_jax(rng):
    """cov_matrix, unit_cov_matrix (padded rows zeroed) and cross_cov per
    lane: same f32 ops, 1e-6 relative."""
    n, pad = 21, 28
    x = np.zeros((pad, 2), np.float32); x[:n] = rng.rand(n, 2)
    mask = np.arange(pad) < n
    cand = rng.rand(6, 2).astype(np.float32)
    h = _hypers(rng, 3, 2)
    xt, mt = _t(x), torch.tensor(mask)
    cov = tl.cov_matrix(xt, mt, _t(h["amp2"]), _t(h["noise"]),
                        _t(h["ls"])).numpy()
    unit = tl.unit_cov_matrix(xt, mt, _t(h["ls"])).numpy()
    cross = tl.cross_cov(xt, _t(cand), _t(h["amp2"]), _t(h["ls"])).numpy()
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    for i in range(3):
        hj = _jax_lane(h, i)
        np.testing.assert_allclose(
            cov[i], np.asarray(jl.cov_matrix(xj, mj, hj.amp2, hj.noise,
                                             hj.ls)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            unit[i], np.asarray(jl.unit_cov_matrix(xj, mj, hj.ls)),
            rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            cross[i], np.asarray(jl.cross_cov(xj, jnp.asarray(cand),
                                              hj.amp2, hj.ls)),
            rtol=1e-6, atol=1e-7)
    assert np.all(unit[:, n:, :] == 0) and np.all(unit[:, :, n:] == 0)


@pytest.mark.parametrize("n,pad", [(12, 16), (50, 56), (64, 64)])
def test_log_marginal_matches_jax_and_golden(rng, n, pad):
    """Per lane against JAX (1e-5 relative: the port's small-pad route, a
    column Cholesky of the assembled K on the CPU, vs XLA's) and the
    float64 oracle (2e-4, the JAX package's own golden tolerance)."""
    d = 3
    x = rng.rand(n, d)
    y = rng.randn(n)
    h = _hypers(rng, 4, d)
    xp, yp, mask = _pad(x, y, pad)
    got = tl.log_marginal(_t(xp), _t(yp), torch.tensor(mask),
                          _torch_h(h)).numpy()
    for i in range(4):
        want_j = float(jl.log_marginal(jnp.asarray(xp), jnp.asarray(yp),
                                       jnp.asarray(mask), _jax_lane(h, i)))
        want_g = numpy_ref.log_marginal(
            x, y, float(h["mean"][i]), float(h["amp2"][i]),
            float(h["noise"][i]), h["ls"][i].astype(np.float64))
        np.testing.assert_allclose(got[i], want_j, rtol=1e-5)
        np.testing.assert_allclose(got[i], want_g, rtol=2e-4)


def test_log_marginal_padding_invariant(rng):
    n, d = 9, 2
    x, y = rng.rand(n, d), rng.randn(n)
    h = tl.GPHypers(torch.zeros(1), torch.ones(1), torch.full((1,), 0.01),
                    torch.ones(1, d))
    outs = []
    for pad in (16, 32, 64, 80):
        xp, yp, mask = _pad(x, y, pad)
        outs.append(float(tl.log_marginal(_t(xp), _t(yp),
                                          torch.tensor(mask), h)[0]))
    np.testing.assert_allclose(outs, outs[0], rtol=1e-6)


def test_log_marginal_failed_factorization_is_neg_inf(rng):
    """A non-PD lane (negative noise) is −inf, as in the JAX package; the
    other lanes are unaffected."""
    n, pad = 10, 16
    x, y = rng.rand(n, 2), rng.randn(n)
    xp, yp, mask = _pad(x, y, pad)
    h = tl.GPHypers(torch.zeros(2), torch.ones(2),
                    torch.tensor([-0.5, 0.01]), torch.ones(2, 2))
    got = tl.log_marginal(_t(xp), _t(yp), torch.tensor(mask), h).numpy()
    want = float(jl.log_marginal(
        jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask),
        jl.GPHypers(jnp.float32(0), jnp.float32(1), jnp.float32(-0.5),
                    jnp.ones(2))))
    assert got[0] == -np.inf and want == -np.inf
    assert np.isfinite(got[1])
