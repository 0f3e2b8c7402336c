"""The port's acquisition: posterior caches, EI, fantasies, L-BFGS.

Deterministic given the hyperparameter samples, so held to the JAX
package element by element: the same samples, the same candidates and
the same fantasy draws (``jax.random.normal`` under the keys the JAX
function uses, handed to the port) go through both.  Against the float64
oracle where it has the function; the batched projected L-BFGS against
``scipy.optimize.fmin_l_bfgs_b`` as in ``tests/test_optimize.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize as spo
import torch

from spearmint_tpu.acquire import ei as jei
from spearmint_tpu.acquire import fantasy as jfant
from spearmint_tpu.core.likelihood import GPHypers as JHypers
from spearmint_tpu.golden import numpy_ref
from spearmint_tpu_torch.acquire import ei as tei
from spearmint_tpu_torch.acquire.fantasy import fantasize_batch
from spearmint_tpu_torch.acquire.optimize import minimize_lbfgs_b
from spearmint_tpu_torch.core.likelihood import GPHypers

torch.set_num_threads(1)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _problem(rng, n, pad, s, d=2):
    """n observations padded to pad, S hyperparameter samples."""
    x = rng.rand(n, d)
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.randn(n)
    xp = np.zeros((pad, d), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    h = dict(mean=rng.uniform(-0.2, 0.4, s), amp2=rng.uniform(0.6, 1.5, s),
             noise=rng.uniform(5e-3, 5e-2, s),
             ls=rng.uniform(0.4, 1.2, (s, d)))
    h = {k: np.asarray(v, np.float32) for k, v in h.items()}
    return x, y, xp, yp, np.arange(pad) < n, h


def _th(h):
    return GPHypers(*(_t(h[f]) for f in GPHypers._fields))


def _jh(h):
    return JHypers(*(jnp.asarray(h[f]) for f in JHypers._fields))


def _jax_caches(xp, yp, mask, h, with_inverse):
    xj, yj, mj = jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask)
    return jax.vmap(lambda hh: jei.make_cache(
        xj, yj, mj, hh, with_inverse=with_inverse))(_jh(h))


def _close_to_max(a, b, frac):
    """|a − b| ≤ frac · max|b|."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=frac * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("with_inverse", [True, False])
def test_make_cache_matches_jax(rng, with_inverse):
    """S=3 samples at n=37 (pad 40).  chol to 1e-5, L⁻¹ to 1e-4 and α to
    1e-3 of their largest entries: f32 factorizations of the same K by
    two routes (shifted kernel form here, XLA's assembled one there)."""
    _, _, xp, yp, mask, h = _problem(rng, 37, 40, 3)
    c = tei.make_cache(_t(xp), _t(yp), torch.tensor(mask), _th(h),
                       with_inverse=with_inverse)
    cj = _jax_caches(xp, yp, mask, h, with_inverse)
    _close_to_max(c.chol.numpy(), np.tril(np.asarray(cj.chol)), 1e-5)
    _close_to_max(c.alpha.numpy(), cj.alpha, 1e-3)
    np.testing.assert_array_equal(c.best.numpy(), np.asarray(cj.best))
    if with_inverse:
        _close_to_max(c.linv.numpy(), cj.linv, 1e-4)
    else:
        assert c.linv is None


@pytest.mark.parametrize("with_inverse", [True, False])
def test_ei_over_candidates_matches_jax(rng, with_inverse):
    """EI [S, C] at 50 candidates: 1e-3 relative and 1e-5 absolute (the
    JAX package's golden EI tolerance).  Chunking the candidates changes
    the GEMM shapes and so the summation order: the same tolerance."""
    _, _, xp, yp, mask, h = _problem(rng, 37, 40, 3)
    cand = rng.rand(50, 2).astype(np.float32)
    c = tei.make_cache(_t(xp), _t(yp), torch.tensor(mask), _th(h),
                       with_inverse=with_inverse)
    got = tei.ei_from_cache(c, _t(xp), torch.tensor(mask), _t(cand)).numpy()
    cj = _jax_caches(xp, yp, mask, h, with_inverse)
    want = jax.vmap(lambda cc: jei.ei_from_cache(
        cc, jnp.asarray(xp), jnp.asarray(mask), jnp.asarray(cand)))(cj)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-5)
    chunked = tei.ei_from_cache_chunked(c, _t(xp), torch.tensor(mask),
                                        _t(cand), chunk=16).numpy()
    np.testing.assert_allclose(chunked, got, rtol=1e-3, atol=1e-5)


def test_posterior_and_ei_match_golden(rng):
    """One sample at n=10 (pad 16) against float64: the JAX package's own
    golden tolerances (tests/test_ei.py)."""
    x, y, xp, yp, mask, h = _problem(rng, 10, 16, 1)
    cand = rng.rand(20, 2)
    hyp = dict(mean=float(h["mean"][0]), amp2=float(h["amp2"][0]),
               noise=float(h["noise"][0]), ls=h["ls"][0].astype(float))
    c = tei.make_cache(_t(xp), _t(yp), torch.tensor(mask), _th(h),
                       with_inverse=True)
    mu, var = tei.posterior_from_cache(c, _t(xp), torch.tensor(mask),
                                       _t(cand))
    want_mu, want_var = numpy_ref.posterior(x, y.astype(float), cand, **hyp)
    np.testing.assert_allclose(mu[0].numpy(), want_mu, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(var[0].numpy(), want_var, rtol=1e-2, atol=1e-4)
    ei = tei.ei_from_cache(c, _t(xp), torch.tensor(mask), _t(cand))
    np.testing.assert_allclose(
        ei[0].numpy(), numpy_ref.compute_ei(x, y.astype(float), cand, **hyp),
        rtol=1e-3, atol=1e-5)


def test_ei_nonnegative_and_zero_at_observed(rng):
    x, y, xp, yp, mask, h = _problem(rng, 10, 16, 2)
    h["noise"][:] = 1e-6
    c = tei.make_cache(_t(xp), _t(yp), torch.tensor(mask), _th(h),
                       with_inverse=True)
    ei = tei.ei_from_cache(c, _t(xp), torch.tensor(mask), _t(x)).numpy()
    assert np.all(ei >= 0) and np.max(ei) < 0.05


def test_grad_ei_vs_finite_diff(rng):
    """∇EI by autograd through the candidate only (the cache is a
    constant), against central differences: 5% or 1e-4."""
    _, _, xp, yp, mask, h = _problem(rng, 10, 16, 1)
    c = tei.make_cache(_t(xp), _t(yp), torch.tensor(mask), _th(h),
                       with_inverse=True)

    def ei_at(pt):
        return tei.ei_from_cache(c, _t(xp), torch.tensor(mask), pt[None])[0, 0]

    pt = _t(rng.rand(2)).requires_grad_(True)
    (g,) = torch.autograd.grad(ei_at(pt), pt)
    eps = 1e-3
    for i in range(2):
        e = torch.zeros(2); e[i] = eps
        with torch.no_grad():
            fd = (float(ei_at(pt + e)) - float(ei_at(pt - e))) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), fd, rtol=0.05, atol=1e-4)


def _pending_case(rng, s=3, n_fant=5):
    _, _, xp, yp, mask, h = _problem(rng, 37, 40, s)
    pend = np.zeros((4, 2), np.float32); pend[:3] = rng.rand(3, 2)
    pend_mask = np.arange(4) < 3
    keys = jax.random.split(jax.random.PRNGKey(4), s)
    draws = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (n_fant, 4), jnp.float32))(keys))
    return xp, yp, mask, h, pend, pend_mask, keys, draws


def test_fantasize_batch_matches_jax_at_same_draws(rng):
    """[S, F, P] fantasies from the standard normals the JAX function draws
    under its keys: 1e-3 relative, 1e-4 absolute (the posterior mean and
    the P×P Cholesky of a near-cancelling covariance, both f32)."""
    xp, yp, mask, h, pend, pend_mask, keys, draws = _pending_case(rng)
    got = fantasize_batch(_t(draws), _t(xp), _t(yp), torch.tensor(mask),
                          _t(pend), torch.tensor(pend_mask), _th(h)).numpy()
    want = jax.vmap(lambda k, hh: jfant.fantasize_batch(
        k, jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask),
        jnp.asarray(pend), jnp.asarray(pend_mask), hh, draws.shape[1]))(
            keys, _jh(h))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4)
    assert np.all(got[..., 3] == 0.0)


def test_make_cache_aug_matches_jax(rng):
    """The augmented cache over obs ∪ pending with a fantasy axis, from
    the same y_augs: α [S, F, N+P] and best [S, F]; chol and L⁻¹ shared
    by the F draws of a sample."""
    xp, yp, mask, h, pend, pend_mask, keys, draws = _pending_case(rng)
    fants = fantasize_batch(_t(draws), _t(xp), _t(yp), torch.tensor(mask),
                            _t(pend), torch.tensor(pend_mask), _th(h))
    n_fant = draws.shape[1]
    y_augs = torch.cat([_t(yp).expand(3, n_fant, -1), fants], -1).numpy()
    x_aug = np.concatenate([xp, pend])
    m_aug = np.concatenate([mask, pend_mask])
    for with_inverse in (True, False):
        c = tei.make_cache_aug(_t(x_aug), torch.tensor(m_aug), _t(y_augs),
                               _th(h), with_inverse=with_inverse)
        cj = jax.vmap(lambda ya, hh: jei.make_cache_aug(
            jnp.asarray(x_aug), jnp.asarray(m_aug), ya, hh,
            with_inverse=with_inverse))(jnp.asarray(y_augs), _jh(h))
        assert c.alpha.shape == (3, n_fant, 44) and c.best.shape == (3, n_fant)
        _close_to_max(c.chol.numpy(), np.tril(np.asarray(cj.chol)), 1e-5)
        _close_to_max(c.alpha.numpy(), cj.alpha, 1e-3)
        np.testing.assert_array_equal(c.best.numpy(), np.asarray(cj.best))
        cand = _t(rng.rand(30, 2))
        ei = tei.ei_from_cache(c, _t(x_aug), torch.tensor(m_aug), cand)
        ei_j = jax.vmap(lambda cc: jei.ei_from_cache(
            cc, jnp.asarray(x_aug), jnp.asarray(m_aug),
            jnp.asarray(cand.numpy())))(cj)
        assert ei.shape == (3, n_fant, 30)
        np.testing.assert_allclose(ei.numpy(), np.asarray(ei_j), rtol=1e-3,
                                   atol=1e-5)


def test_fantasy_moments_match_golden(rng):
    """400 fantasies of one sample average to the float64 posterior mean
    at the pending points (the JAX package's 0.15 Monte-Carlo band)."""
    x, y, xp, yp, mask, h = _problem(rng, 10, 16, 1)
    pend = np.zeros((4, 2), np.float32); pend[:3] = rng.rand(3, 2)
    draws = torch.tensor(np.random.RandomState(0).randn(1, 400, 4),
                         dtype=torch.float32)
    f = fantasize_batch(draws, _t(xp), _t(yp), torch.tensor(mask), _t(pend),
                        torch.tensor(np.arange(4) < 3), _th(h))[0, :, :3]
    want_mu, _ = numpy_ref.posterior(
        x, y.astype(float), pend[:3].astype(float), float(h["mean"][0]),
        float(h["amp2"][0]), float(h["noise"][0]), h["ls"][0].astype(float))
    np.testing.assert_allclose(f.numpy().mean(0), want_mu, atol=0.15)


# --------------------------------------------------------------- L-BFGS
def _box(d, dtype=torch.float32):
    return torch.zeros(d, dtype=dtype), torch.ones(d, dtype=dtype)


def test_quadratic_interior():
    target = torch.tensor([0.3, 0.7])
    res = minimize_lbfgs_b(lambda x: ((x - target) ** 2).sum(-1),
                           torch.tensor([[0.9, 0.1]]), *_box(2), iters=60)
    np.testing.assert_allclose(res.x[0].numpy(), target.numpy(), atol=1e-4)


def test_optimum_on_boundary():
    def fun(x):
        return (x[:, 0] + 1.0) ** 2 + (x[:, 1] - 2.0) ** 2

    res = minimize_lbfgs_b(fun, torch.tensor([[0.5, 0.5]]), *_box(2),
                           iters=60)
    np.testing.assert_allclose(res.x[0].numpy(), [0.0, 1.0], atol=1e-4)


def test_rosenbrock_matches_scipy(rng):
    def rosen_np(x):
        return float(100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2)

    def rosen(x):
        return 100 * (x[:, 1] - x[:, 0] ** 2) ** 2 + (1 - x[:, 0]) ** 2

    starts = rng.rand(6, 2).astype(np.float32)
    res = minimize_lbfgs_b(rosen, _t(starts), *_box(2), iters=200,
                           history=10)
    best = float(res.fun.min())
    sp_best = min(spo.fmin_l_bfgs_b(rosen_np, s, approx_grad=True,
                                    bounds=[(0, 1), (0, 1)])[1]
                  for s in starts)
    assert best <= sp_best + 1e-3
    assert best < 1e-4


def test_batched_starts_pick_distinct_basins():
    def fun(x):
        return ((x[:, 0] - 0.2) ** 2) * ((x[:, 0] - 0.8) ** 2) + x[:, 1] ** 2

    res = minimize_lbfgs_b(fun, torch.tensor([[0.1, 0.5], [0.9, 0.5]]),
                           *_box(2), iters=100)
    xs = res.x[:, 0].numpy()
    assert abs(xs[0] - 0.2) < 0.05 and abs(xs[1] - 0.8) < 0.05


def test_bound_active_quadratics_match_scipy(rng):
    """Random quadratics with minima outside the box (float64): the
    active-set step lands on scipy's bound-active solution."""
    d = 4
    for trial in range(5):
        a = rng.randn(d, d)
        q = a @ a.T + d * np.eye(d)
        center = 1.5 * rng.randn(d)

        def f_np(x):
            r = x - center
            return float(0.5 * r @ q @ r)

        x0 = rng.rand(d)
        want_x, want_f, _ = spo.fmin_l_bfgs_b(
            f_np, x0.copy(), fprime=lambda x: q @ (x - center),
            bounds=[(0, 1)] * d)
        qt, ct = _t(q, torch.float64), _t(center, torch.float64)

        def fun(x):
            r = x - ct
            return 0.5 * ((r @ qt) * r).sum(-1)

        res = minimize_lbfgs_b(fun, _t(x0, torch.float64)[None],
                               *_box(d, torch.float64), iters=100)
        np.testing.assert_allclose(res.x[0].numpy(), want_x, atol=5e-5,
                                   err_msg=f"trial {trial}")
        assert float(res.fun[0]) <= want_f + 1e-6 * max(1.0, abs(want_f))


def test_active_set_does_not_stick_interior_optimum():
    starts = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    res = minimize_lbfgs_b(lambda x: ((x - 0.5) ** 2).sum(-1), starts,
                           *_box(2), iters=50)
    np.testing.assert_allclose(res.x.numpy(), 0.5 * np.ones((3, 2)),
                               atol=1e-4)
