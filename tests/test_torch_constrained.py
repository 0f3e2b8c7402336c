"""The port's constrained-EI slice on the CPU (``device="cpu"``), against
the JAX package (``spearmint_tpu/engine/constrained.py``), the float64
oracle (``spearmint_tpu/golden/numpy_ref.py``) and float64 linear algebra.

The deterministic parts — the constraint covariance, the probit
likelihood, the two move densities, the caches and the feasibility
probability at a fixed state — are held element by element, on the same
numpy inputs and a state carried across with ``convert.py``.  The
sampled parts (ESS, the whole suggestion) draw from ``torch.Generator``
where the JAX package draws from ``jax.random``, so they are held in
distribution.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as spla
import scipy.stats as sps
import torch

from spearmint_tpu.core import linalg as jlinalg
from spearmint_tpu.core import priors as jpriors
from spearmint_tpu.core.kernels import matern52 as jmatern52
from spearmint_tpu.engine import constrained as jc
from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.convert import (
    constraint_from_numpy, constraint_to_numpy,
)
from spearmint_tpu_torch.core import linalg as tlinalg
from spearmint_tpu_torch.engine import constrained as tc
from spearmint_tpu_torch.engine.suggest import (
    SuggestConfig, init_chain_states,
)
from spearmint_tpu_torch.mcmc import ess

torch.set_num_threads(1)


# ------------------------------------------------------------------ ESS
def test_ess_samples_gaussian_posterior():
    """Prior N(0, I), likelihood N(obs | f, s²): the known Gaussian
    posterior, from 16 chains in lockstep (tests/test_constrained.py's
    criteria: moments to 0.1, KS p > 0.005 on thinned draws)."""
    obs = torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
    s2, k_chains = 0.5, 16
    chol = torch.eye(3, dtype=torch.float64).expand(k_chains, 3, 3)

    def log_lik(f):
        return -0.5 * ((obs - f) ** 2).sum(-1) / s2

    gen = torch.Generator()
    gen.manual_seed(0)
    f = torch.zeros(k_chains, 3, dtype=torch.float64)
    draws = []
    for i in range(400):
        f = ess.elliptical_slice(gen, f, chol, log_lik)
        if i >= 100:
            draws.append(f.clone())
    samples = torch.stack(draws, 1).numpy()           # [chains, 300, 3]
    want_mean = obs.numpy() / (1 + s2)
    want_std = np.sqrt(s2 / (1 + s2))
    flat = samples.reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(0), want_mean, atol=0.1)
    np.testing.assert_allclose(flat.std(0), want_std, atol=0.1)
    _, p = sps.kstest((samples[:, ::10, 0].ravel() - want_mean[0])
                      / want_std, "norm")
    assert p > 0.005, p


def test_ess_chain_that_never_accepts_stays_put():
    """A chain whose likelihood is NaN everywhere rejects MAX_SHRINK times
    and keeps its state; its neighbour in the batch still moves."""
    gen = torch.Generator()
    gen.manual_seed(1)
    f0 = torch.tensor([[0.3, -0.2], [0.1, 0.4]])
    chol = torch.eye(2).expand(2, 2, 2)

    def log_lik(f):
        lp = -0.5 * (f * f).sum(-1)
        return torch.stack([lp[0], torch.tensor(float("nan"))])

    f1 = ess.elliptical_slice(gen, f0, chol, log_lik)
    assert torch.equal(f1[1], f0[1])
    assert not torch.equal(f1[0], f0[0])


# ------------------------------------------------------ fixed-state model
def _fixed_case(seed=0, n=13, pad=16, k=3, d=2):
    """Points, labels and a numpy constraint state {c_ls, c_amp2, c_ff}
    (latents = z·|N(0,1)| on real rows, 0 on padded ones)."""
    rng = np.random.RandomState(seed)
    xp = np.zeros((pad, d), np.float32)
    xp[:n] = rng.rand(n, d)
    mask = np.arange(pad) < n
    z = np.where(mask, np.where(rng.rand(pad) > 0.4, 1.0, -1.0), 1.0)
    ff = np.where(mask, z * np.abs(rng.randn(k, pad)), 0.0)
    arrays = {"c_ls": rng.uniform(0.2, 0.6, (k, d)).astype(np.float32),
              "c_amp2": rng.uniform(0.5, 2.0, k).astype(np.float32),
              "c_ff": ff.astype(np.float32)}
    cand = rng.rand(40, d).astype(np.float32)
    return xp, mask, z.astype(np.float32), arrays, cand


def _jax_lanes(arrays):
    return [jc.ConstraintState(ls=jnp.asarray(arrays["c_ls"][i]),
                               amp2=jnp.asarray(arrays["c_amp2"][i]),
                               ff=jnp.asarray(arrays["c_ff"][i]))
            for i in range(len(arrays["c_amp2"]))]


def _jax_ls_logprob(ls, st, xj, mj, max_ls=2.0):
    """The JAX sweep's ls-move density (a closure in _sample_constraint),
    written out from the JAX package's own functions."""
    valid = jpriors.ls_in_bounds(ls, max_ls)
    k = jc._constraint_cov(xj, mj, jnp.clip(ls, 1e-6, max_ls), st.amp2,
                           jmatern52)
    ld, q = jlinalg.chol_logdet_q(k, st.ff)
    lp = -ld - 0.5 * q
    return float(jnp.where(valid, jnp.where(jnp.isnan(lp), -jnp.inf, lp),
                           -jnp.inf))


def _jax_amp2_logprob(a, st, xj, mj):
    """The JAX sweep's closed-form amp2 density, from its own functions."""
    unit = jc._constraint_cov(xj, mj, st.ls, jnp.asarray(1.0), jmatern52)
    chu = jlinalg.cholesky(unit)
    wu = jlinalg.tri_solve(chu, st.ff)
    n_eff = jnp.sum(mj.astype(jnp.float32))
    a_s = a if a > 0 else 1.0
    lp = (-0.5 * n_eff * jnp.log(a_s) - jlinalg.logdet_from_chol(chu)
          - 0.5 * jnp.dot(wu, wu) / a_s
          + jpriors.lognormal_amp2_term(jnp.float32(a_s)))
    return float(lp) if a > 0 else -np.inf


def test_constraint_model_matches_jax_at_fixed_state():
    """Covariances and the probit likelihood element by element (float32
    arithmetic in the same order: 1e-6 relative); the two move densities
    to 1e-4 relative (f32 factorizations by two schedules)."""
    xp, mask, z, arrays, _ = _fixed_case()
    st = constraint_from_numpy(arrays, "cpu")
    xt, mt, zt = torch.tensor(xp), torch.tensor(mask), torch.tensor(z)
    xj, mj = jnp.asarray(xp), jnp.asarray(mask)
    lanes = _jax_lanes(arrays)

    cov = tc._constraint_cov(xt, mt, st.ls, st.amp2)
    unit = tc._constraint_unit_cov(xt, mt, st.ls)
    for i, s in enumerate(lanes):
        np.testing.assert_allclose(
            cov[i].numpy(),
            np.asarray(jc._constraint_cov(xj, mj, s.ls, s.amp2, jmatern52)),
            rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            unit[i].numpy(),
            np.asarray(jc._constraint_unit_cov(xj, mj, s.ls, jmatern52)),
            rtol=1e-6, atol=1e-7)
    ll = tc._probit_loglik(st.ff, zt, mt).numpy()
    for i, s in enumerate(lanes):
        want = float(jc._probit_loglik(s.ff, jnp.asarray(z), mj))
        np.testing.assert_allclose(ll[i], want, rtol=1e-6)

    # ls move: in bounds, and one lane past max_ls (−inf in both)
    ls = st.ls.clone()
    ls[2, 1] = 2.5
    lp = tc._ls_logprob(ls, xt, mt, st.amp2, st.ff, tc.matern52, 2.0)
    for i, s in enumerate(lanes):
        want = _jax_ls_logprob(jnp.asarray(ls[i].numpy()), s, xj, mj)
        if np.isinf(want):
            assert float(lp[i]) == want
        else:
            np.testing.assert_allclose(float(lp[i]), want, rtol=1e-4)
    assert np.isinf(float(lp[2]))

    # amp2 move: closed form off one unit factorization
    half, quad = tc._unit_terms(xt, mt, st.ls, st.ff, tc.matern52)
    n_eff = mt.float().sum()
    for a in (0.4, 1.3, 3.0, -1.0):
        got = tc._amp2_logprob(torch.full((3, 1), a), n_eff, half, quad)
        for i, s in enumerate(lanes):
            want = _jax_amp2_logprob(a, s, xj, mj)
            if np.isinf(want):
                assert float(got[i]) == want
            else:
                np.testing.assert_allclose(float(got[i]), want, rtol=1e-4)


def test_constraint_cache_and_p_valid_match_jax():
    """_make_constraint_cache (B2 + B3) and _p_valid_from_cache against the
    JAX functions per lane: L⁻¹ and α to 1e-3 of their largest entry, the
    feasibility probability to 1e-3 absolute (cond(K) reaches 4e4 here;
    each package is within 7e-4 of float64)."""
    xp, mask, _, arrays, cand = _fixed_case(seed=1)
    st = constraint_from_numpy(arrays, "cpu")
    xt, mt, ct = torch.tensor(xp), torch.tensor(mask), torch.tensor(cand)
    xj, mj = jnp.asarray(xp), jnp.asarray(mask)
    cache = tc._make_constraint_cache(st, xt, mt)
    pv = tc._p_valid_from_cache(cache, xt, mt, ct).numpy()
    for i, s in enumerate(_jax_lanes(arrays)):
        jcache = jc._make_constraint_cache(s, xj, mj, jmatern52)
        for got, want in ((cache.linv[i], jcache.linv),
                          (cache.alpha[i], jcache.alpha)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want,
                                       atol=1e-3 * np.abs(want).max())
        want_pv = np.asarray(jc._p_valid_from_cache(jcache, xj, mj,
                                                    jnp.asarray(cand),
                                                    jmatern52))
        np.testing.assert_allclose(pv[i], want_pv, atol=1e-3)
    # the one-shot form is the same computation
    np.testing.assert_array_equal(tc._p_valid_at(st, xt, mt, ct).numpy(), pv)


@pytest.mark.parametrize("n_real,pad", [(40, 48), (60, 64)])
def test_chol_logdet_q_matches_jax_and_f64(n_real, pad):
    """linalg.chol_logdet_q (B4a's plain version) on the constraint
    covariance, padded rows identity, against the JAX package's
    chol_logdet_q on the CPU (XLA's Cholesky) and float64.  cond(K) is
    70 to 3e4 at these length scales, so cond·eps ≤ 2e-3 bounds q's
    relative error: q to 2e-3, ld to 5e-5 relative."""
    rng = np.random.RandomState(n_real)
    xp = np.zeros((pad, 2), np.float32)
    xp[:n_real] = rng.rand(n_real, 2)
    mask = np.arange(pad) < n_real
    ls = rng.uniform(0.05, 0.12, (3, 2)).astype(np.float32)
    amp2 = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    k = tc._constraint_cov(torch.tensor(xp), torch.tensor(mask),
                           torch.tensor(ls), torch.tensor(amp2))
    ff = np.where(mask, rng.randn(3, pad), 0.0).astype(np.float32)
    ld, q = tlinalg.chol_logdet_q(k, torch.tensor(ff))
    kj = jnp.asarray(k.numpy())
    jld, jq = jax.vmap(jlinalg.chol_logdet_q)(kj, jnp.asarray(ff))
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=5e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=2e-3)
    k64 = k.numpy().astype(np.float64)
    chol = np.linalg.cholesky(k64)
    w = np.stack([spla.solve_triangular(c, v, lower=True)
                  for c, v in zip(chol, ff.astype(np.float64))])
    np.testing.assert_allclose(
        ld.numpy(), np.log(np.diagonal(chol, axis1=1, axis2=2)).sum(-1),
        rtol=5e-5)
    np.testing.assert_allclose(q.numpy(), (w * w).sum(-1), rtol=2e-3)
    # the padded rows add nothing: the unpadded problem gives the same,
    # and so does the library route on the raw (unmasked) covariance
    s = slice(0, n_real)
    ld0, q0 = tlinalg.chol_logdet_q(k[:, s, s], torch.tensor(ff[:, s]))
    np.testing.assert_allclose(ld.numpy(), ld0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(q.numpy(), q0.numpy(), rtol=1e-6)
    raw = tc._constraint_cov(torch.tensor(xp), torch.ones(pad, dtype=bool),
                             torch.tensor(ls), torch.tensor(amp2))
    ld_lib = tlinalg.logdet_from_chol(
        tlinalg.masked_cholesky(raw, torch.tensor(mask)))
    np.testing.assert_allclose(ld_lib.numpy(), ld.numpy(), rtol=5e-5)


def test_c2_blocked_factorization_nan_edge():
    """ROADMAP C2, repaired: on the constraint covariance of 200 points
    (pad 256, jitter 1e-6, no noise term) the port's chol_logdet_q takes
    the library route below pad 512 (``kernel_ok``), as the JAX package
    does, and is finite at ls = 0.3 (cond ≈ 5e7) and ls = 0.5 (cond ≈
    1e8) alike.  The blocked float32 factorization — B4a's plain version,
    on the CUDA kernel's schedule, and the Pallas kernel in interpret mode
    — still gives NaN at ls = 0.5: that edge is the blocked kernel's, and
    it now meets only pads ≥ 512.  At cond ≈ 1e8 a float32 Cholesky keeps
    about one digit of q: the two libraries are held to 1e-3 (ld) and
    0.15 (q) relative of each other, and the port to the same of float64
    (measured: q 7% apart, each within 6% of float64)."""
    from spearmint_tpu.ops.pallas_gp import logdet_q_pallas
    from spearmint_tpu_torch.ops import gp_kernels

    n, pad = 200, 256
    rng = np.random.RandomState(2)
    xp = np.zeros((pad, 2), np.float32)
    xp[:n] = rng.rand(n, 2)
    mask = np.arange(pad) < n
    ff = np.where(mask, rng.randn(pad), 0.0).astype(np.float32)[None]
    assert not tlinalg.kernel_ok(pad)
    for ls, blocked_finite in ((0.3, True), (0.5, False)):
        k = tc._constraint_cov(torch.tensor(xp), torch.tensor(mask),
                               torch.full((1, 2), ls), torch.ones(1))
        ld, q = tlinalg.chol_logdet_q(k, torch.tensor(ff))
        x_ld, x_q = jlinalg.chol_logdet_q(jnp.asarray(k[0].numpy()),
                                          jnp.asarray(ff[0]))
        p_ld, p_q = logdet_q_pallas(jnp.asarray(k.numpy()), jnp.asarray(ff),
                                    block=128, sub=32, interpret=True)
        b_ld, b_q = gp_kernels.logdet_q_ref(k, torch.tensor(ff))
        for v in (ld, q, x_ld, x_q):
            assert bool(np.isfinite(np.asarray(v)).all()), (ls, v)
        for v in (p_ld, p_q, b_ld, b_q):
            assert bool(np.isfinite(np.asarray(v)).all()) == blocked_finite
        chol = np.linalg.cholesky(k[0].double().numpy())
        w = spla.solve_triangular(chol, ff[0].astype(np.float64), lower=True)
        for want_ld, want_q in ((x_ld, x_q),
                                (np.log(np.diag(chol)).sum(), w @ w)):
            np.testing.assert_allclose(float(ld[0]), float(want_ld),
                                       rtol=1e-3)
            np.testing.assert_allclose(float(q[0]), float(want_q), rtol=0.15)
        if blocked_finite:
            np.testing.assert_allclose(ld.numpy(), np.asarray(p_ld),
                                       rtol=1e-3)


def test_constrained_acquisition_formula_matches_golden_at_fixed_state():
    """EI over the valid observations times Φ(μ_f/√(1+σ²_f)) at one fixed
    (value hypers, constraint state) against the float64 NumPy formula,
    at the JAX test's tolerances (pv 2e-3/2e-4, product 5e-3 and 5e-4 of
    its largest entry)."""
    from spearmint_tpu.golden import numpy_ref as g
    from spearmint_tpu_torch.acquire import ei as tei
    from spearmint_tpu_torch.core.likelihood import GPHypers

    rng = np.random.RandomState(9)
    n, pad, d, c = 13, 16, 2, 48
    x = rng.rand(n, d)
    valid = rng.rand(n) > 0.4
    y = np.where(valid, np.sin(4 * x[:, 0]) + 0.1 * rng.randn(n), 0.0)
    ff = np.where(valid, np.abs(rng.randn(n)), -np.abs(rng.randn(n)))
    cand = rng.rand(c, d)
    amp2_c, ls_c = 1.4, np.array([0.8, 0.5])
    hv = dict(mean=float(y[valid].mean()), amp2=1.1, noise=5e-3,
              ls=np.array([0.6, 0.9]))

    want_ei = g.compute_ei(x[valid], y[valid], cand, **hv)
    kcc = amp2_c * (g.matern52(x, x, ls_c) + 1e-6 * np.eye(n))
    kxc = amp2_c * g.matern52(x, cand, ls_c)
    chol = spla.cholesky(kcc, lower=True)
    mu_f = kxc.T @ spla.cho_solve((chol, True), ff)
    beta = spla.solve_triangular(chol, kxc, lower=True)
    var_f = amp2_c * (1 + 1e-6) - (beta ** 2).sum(0)
    want_pv = sps.norm.cdf(mu_f / np.sqrt(1.0 + np.maximum(var_f, 1e-10)))
    want = want_ei * want_pv

    xp = np.zeros((pad, d), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    ffp = np.zeros((1, pad), np.float32); ffp[0, :n] = ff
    obs = torch.tensor(np.arange(pad) < n)
    vmask = np.zeros(pad, bool); vmask[:n] = valid
    xt, yt, ct = (torch.tensor(xp), torch.tensor(yp),
                  torch.tensor(cand, dtype=torch.float32))
    h = GPHypers(*(torch.tensor(np.atleast_1d(v), dtype=torch.float32)
                   for v in (hv["mean"], hv["amp2"], hv["noise"])),
                 torch.tensor(hv["ls"][None], dtype=torch.float32))
    state = constraint_from_numpy({"c_ls": ls_c[None], "c_amp2": [amp2_c],
                                   "c_ff": ffp}, "cpu")
    cache = tei.make_cache(xt, yt, torch.tensor(vmask), h,
                           with_inverse=True)
    ei = tei.ei_from_cache(cache, xt, torch.tensor(vmask), ct)[0].numpy()
    pv = tc._p_valid_at(state, xt, obs, ct)[0].numpy()
    np.testing.assert_allclose(pv, want_pv, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(ei * pv, want, rtol=5e-3,
                               atol=5e-4 * np.abs(want).max())


def test_constraint_state_round_trips_through_numpy():
    _, _, _, arrays, _ = _fixed_case()
    back = constraint_to_numpy(constraint_from_numpy(arrays, "cpu"))
    assert sorted(back) == ["c_amp2", "c_ff", "c_ls"]
    for k, v in arrays.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v)


# ------------------------------------------------------------ the slice
def _violation_problem():
    """tests/test_constrained.py's problem: the objective improves toward
    x0 = 1, but x0 > 0.6 is infeasible."""
    rng = np.random.RandomState(0)
    n, pad = 24, 32
    x = rng.rand(n, 2).astype(np.float32)
    valid = x[:, 0] <= 0.6
    y_raw = 5.0 * (1.0 - x[:, 0]) + 0.05 * rng.randn(n)
    xp = np.zeros((pad, 2), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = np.where(valid, y_raw, 0.0)
    obs_mask = np.arange(pad) < n
    valid_mask = np.zeros(pad, bool); valid_mask[:n] = valid
    cand = rng.rand(64, 2).astype(np.float32)
    return xp, yp, valid_mask, obs_mask, cand


def test_constrained_avoids_violating_region():
    """Four seeds of three sweeps from the initial states: the classifier
    learns the split (mean feasibility over x0 < 0.4 above that over
    x0 > 0.8 in every run, by 0.15 — the JAX test's margin — on average
    over the runs), and the acquisition averaged over the runs peaks at
    x0 < 0.8.  (The JAX test holds one key to both: over keys 0-3 the JAX
    package's margin ranges 0.26-0.40 and its argmax lies at x0 > 0.8 for
    one key in four, as EI grows toward x0 = 1; the port's margin ranges
    0.15-0.45.)"""
    xp, yp, vmask, omask, cand = _violation_problem()
    cfg = SuggestConfig(mcmc_iters=3, optimize=False)
    acq_sum, margins = np.zeros(64), []
    for seed in range(4):
        gen = torch.Generator()
        gen.manual_seed(seed)
        h = init_chain_states(torch.tensor(yp), torch.tensor(vmask), 2, 4)
        c = tc.init_constraint_states(2, 32, 4, device="cpu")
        res = tc.suggest_step_constrained(gen, h, c, xp, yp, vmask, omask,
                                          cand, np.ones(64, bool), cfg,
                                          device="cpu")
        pv = res.p_valid.numpy()
        assert int(res.n_ok) == 12
        assert np.all(np.isfinite(pv)) and np.all((pv >= 0) & (pv <= 1))
        margins.append(pv[cand[:, 0] < 0.4].mean()
                       - pv[cand[:, 0] > 0.8].mean())
        acq_sum += res.acq.numpy() / res.acq.numpy().max()
    assert min(margins) > 0.0 and np.mean(margins) > 0.15, margins
    assert cand[int(np.argmax(acq_sum)), 0] < 0.8


def test_constrained_chunked_matches_unchunked(monkeypatch):
    """chain_chunk and explicit_inverse must not change the acquisition.
    The draws of one torch.Generator depend on how the chains are grouped,
    so both samplers are held still here (every sample equals its chain's
    distinct fixed state) and the rest of the step — sample bookkeeping,
    both cache families, the acquisition and the L-BFGS — runs in groups
    of 2 against one batch: the JAX test's tolerance, 2e-4 relative, on
    the acquisition."""
    def still(gen, x0, logprob, compwise=False, lp0=None, **kw):
        return x0, logprob(x0)

    monkeypatch.setattr(tc, "slice_sample", still)
    monkeypatch.setattr(tc, "elliptical_slice", lambda gen, f, chol, ll: f)
    monkeypatch.setattr("spearmint_tpu_torch.mcmc.chains.slice_sample",
                        still)
    rng = np.random.RandomState(6)
    n, pad = 14, 16
    x = rng.rand(n, 2).astype(np.float32)
    vals = (x[:, 0] ** 2 + 0.05 * rng.randn(n)).astype(np.float64)
    vals[x[:, 1] > 0.7] = np.nan
    xp = np.zeros((pad, 2), np.float32); xp[:n] = x
    valid = np.zeros(pad, bool); valid[:n] = np.isfinite(vals)
    yp = np.zeros(pad, np.float32)
    yp[:n] = np.where(np.isfinite(vals), vals, 0.0)
    obs = np.arange(pad) < n
    cand = rng.rand(32, 2).astype(np.float32)
    h = init_chain_states(torch.tensor(yp), torch.tensor(valid), 2, 4)
    h = h._replace(ls=torch.tensor(rng.uniform(0.3, 1.0, (4, 2)),
                                   dtype=torch.float32))
    z = np.where(valid, 1.0, -1.0)
    c0 = tc.ConstraintState(
        ls=torch.tensor(rng.uniform(0.3, 1.0, (4, 2)), dtype=torch.float32),
        amp2=torch.tensor(rng.uniform(0.5, 2.0, 4), dtype=torch.float32),
        ff=torch.tensor(np.where(obs, z * np.abs(rng.randn(4, pad)), 0.0),
                        dtype=torch.float32))
    out = []
    for kw in (dict(), dict(chain_chunk=2, explicit_inverse=False)):
        gen = torch.Generator()
        gen.manual_seed(7)
        out.append(tc.suggest_step_constrained(
            gen, h, c0, xp, yp, valid, obs, cand, np.ones(32, bool),
            SuggestConfig(mcmc_iters=2, grid_subset=3, lbfgs_iters=5, **kw),
            device="cpu"))
    base, chunked = out
    for a, b in zip(base.c_samples, chunked.c_samples):
        assert torch.equal(a, b)
    np.testing.assert_allclose(base.acq.numpy(), chunked.acq.numpy(),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(base.p_valid.numpy(), chunked.p_valid.numpy(),
                               rtol=2e-4, atol=1e-7)
    assert int(base.best_cand) == int(chunked.best_cand)
    # the L-BFGS objective differs in the last bits (L⁻¹ GEMMs against
    # triangular solves), which five steps carry to 1e-3 in x
    np.testing.assert_allclose(float(base.acq_opt), float(chunked.acq_opt),
                               rtol=1e-3)


# ----------------------------------------------------------- the chooser
def _constrained_problem(rng, n_grid=40, n_comp=12):
    grid = rng.rand(n_grid, 2)
    values = np.full(n_grid, np.nan)
    complete = np.arange(n_comp)
    vals = 2.0 * grid[complete, 1] + 0.1 * rng.randn(n_comp)
    vals[grid[complete, 0] > 0.5] = np.nan   # violations
    values[complete] = vals
    return grid, values, np.arange(n_comp, n_grid), complete


ARGS = "mcmc_iters=4,chains=3,burnin=15,grid_subset=3,lbfgs_iters=8"


def test_constrained_chooser_protocol(tmp_path):
    """Fewer than two completions or two valid ones: the next grid
    candidate; otherwise an index or an (acq, x) tuple in the box."""
    rng = np.random.RandomState(1)
    chooser = get_chooser(
        "GPConstrainedEIChooser", str(tmp_path),
        "mcmc_iters=2,chains=3,burnin=10,grid_subset=3,lbfgs_iters=8,"
        "device=cpu")
    grid, values, candidates, complete = _constrained_problem(rng)
    out = chooser.next(grid, values, np.full(40, np.nan), candidates, [],
                       complete)
    assert isinstance(out, (int, tuple))
    if isinstance(out, tuple):
        assert np.all((out[1] >= 0) & (out[1] <= 1)) and out[0] > 0
    else:
        assert out in candidates
    all_bad = values.copy()
    all_bad[complete[1:]] = np.nan
    assert chooser.next(grid, all_bad, np.full(40, np.nan), candidates, [],
                        complete) == int(candidates[0])


def test_constrained_samples_amp2_and_persists_state(tmp_path):
    """The constraint amp2 is sampled (moves off 1.0), the latents move
    off zero, and the whole state survives a restart and advances."""
    rng = np.random.RandomState(2)
    chooser = get_chooser("GPConstrainedEIChooser", str(tmp_path),
                          ARGS + ",device=cpu")
    grid, values, candidates, complete = _constrained_problem(rng)
    chooser.next(grid, values, np.full(40, np.nan), candidates, [], complete)
    path = os.path.join(str(tmp_path), "GPConstrainedEIChooser_state.npz")
    with np.load(path) as z:
        saved = {k: z[k].copy() for k in ("c_ls", "c_amp2", "c_ff")}
    assert saved["c_amp2"].shape == (3,)
    assert np.any(np.abs(saved["c_amp2"] - 1.0) > 1e-3)
    assert np.any(np.abs(saved["c_ff"][:, :12]) > 1e-3)

    chooser2 = get_chooser("GPConstrainedEIChooser", str(tmp_path),
                           ARGS + ",device=cpu")
    chooser2._load_state(2)
    assert chooser2._burned_in
    for k, v in constraint_to_numpy(chooser2._constraint).items():
        np.testing.assert_array_equal(v, saved[k])
    out = chooser2.next(grid, values, np.full(40, np.nan), candidates, [],
                        complete)
    assert isinstance(out, (int, tuple))
    with np.load(path) as z:
        assert not np.array_equal(z["c_ff"], saved["c_ff"])


def test_constrained_state_resumes_across_packages(tmp_path):
    """The JAX chooser's state file resumes in the port (pad 16 → 20: the
    latents are re-padded keeping their prefix), and the port's file
    resumes in the JAX chooser with the same keys and values."""
    from spearmint_tpu.choosers.GPConstrainedEIChooser import (
        GPConstrainedEIChooser as JaxChooser,
    )
    from spearmint_tpu.core.likelihood import GPHypers as JHypers

    expt = str(tmp_path)
    rng = np.random.RandomState(4)
    jchooser = JaxChooser(expt, chains=3)
    jchooser._hypers = JHypers(
        jnp.asarray(rng.uniform(-1, 1, 3), jnp.float32),
        jnp.asarray(rng.uniform(0.5, 2, 3), jnp.float32),
        jnp.asarray(rng.uniform(1e-3, 0.1, 3), jnp.float32),
        jnp.asarray(rng.uniform(0.3, 1.5, (3, 2)), jnp.float32))
    ff = np.zeros((3, 16), np.float32)
    ff[:, :12] = rng.randn(3, 12)
    jchooser._constraint = jc.ConstraintState(
        ls=jnp.asarray(rng.uniform(0.3, 1.5, (3, 2)), jnp.float32),
        amp2=jnp.asarray(rng.uniform(0.5, 2, 3), jnp.float32),
        ff=jnp.asarray(ff))
    jchooser._key_state, jchooser._burned_in = 11, True
    jchooser._save_state()

    port = get_chooser("GPConstrainedEIChooser", expt, ARGS + ",device=cpu")
    port._load_state(2)
    np.testing.assert_array_equal(port._constraint.ff.numpy(), ff)
    np.testing.assert_array_equal(port._constraint.amp2.numpy(),
                                  np.asarray(jchooser._constraint.amp2))
    assert port._key_state == 11 and port._burned_in
    grid, values, candidates, complete = _constrained_problem(
        np.random.RandomState(5), n_comp=17)
    port.next(grid, values, np.full(40, np.nan), candidates, [], complete)
    assert port._key_state == 12 and port._constraint.ff.shape == (3, 20)

    with np.load(os.path.join(expt, "GPConstrainedEIChooser_state.npz")) as z:
        assert sorted(z.files) == ["amp2", "burned_in", "c_amp2", "c_ff",
                                   "c_ls", "key_state", "ls", "mean",
                                   "noise"]
        assert z["c_ff"].dtype == np.float32 and z["c_ff"].shape == (3, 20)
    jc2 = JaxChooser(expt, chains=3)
    jc2._load_state(2)
    for a, b in zip(jc2._constraint, port._constraint):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jc2._hypers, port._hypers):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jc2._key_state == 12 and jc2._burned_in


def test_degenerate_suggestion_keeps_both_chain_families(tmp_path,
                                                         monkeypatch):
    """n_ok == 0: grid order, a suggest_degenerate event, neither the value
    nor the constraint chain states replaced (the JAX chooser saves
    both), and the key advances."""
    from spearmint_tpu_torch.choosers import GPConstrainedEIChooser as mod

    rng = np.random.RandomState(3)
    grid, values, candidates, complete = _constrained_problem(rng)
    chooser = mod.GPConstrainedEIChooser(
        str(tmp_path), chains=2, mcmc_iters=2, burnin=2, grid_subset=3,
        lbfgs_iters=5, device="cpu")
    chooser.next(grid, values, np.zeros(40), candidates, [], complete)
    before_h = [a.clone() for a in chooser._hypers]
    before_c = [a.clone() for a in chooser._constraint]
    real = tc.suggest_step_constrained

    def failed(*a, **k):
        return real(*a, **k)._replace(n_ok=torch.tensor(0))

    monkeypatch.setattr(tc, "suggest_step_constrained", failed)
    assert chooser.next(grid, values, np.zeros(40), candidates, [],
                        complete) == int(candidates[0])
    assert "suggest_degenerate" in [e["kind"] for e in chooser.events.read()]
    for a, b in zip((*chooser._hypers, *chooser._constraint),
                    (*before_h, *before_c)):
        assert torch.equal(a, b)
    with np.load(str(tmp_path / "GPConstrainedEIChooser_state.npz")) as z:
        np.testing.assert_array_equal(z["c_ff"], before_c[2].numpy())
        np.testing.assert_array_equal(z["ls"], before_h[3].numpy())
        assert int(z["key_state"]) == 2


def test_constrained_entry_points_need_a_card_or_the_cpu(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp, yp, vmask, omask, cand = _violation_problem()
    h = init_chain_states(torch.tensor(yp), torch.tensor(vmask), 2, 2)
    c = tc.init_constraint_states(2, 32, 2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.suggest_step_constrained(torch.Generator(), h, c, xp, yp, vmask,
                                    omask, cand, np.ones(64, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.init_constraint_states(2, 32, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_chooser("GPConstrainedEIChooser", str(tmp_path))
