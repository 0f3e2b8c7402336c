"""The port's batched slice sampler and hyperparameter chains.

Distributional checks in the pattern of ``tests/test_slice.py`` (known
densities, KS tests) with all chains of a batch advancing in lockstep,
the phase machine's guards, and posterior moments on a small GP against
the JAX package and the float64 oracle in the pattern of
``tests/test_parity.py``.  The port draws from ``torch.Generator``s and
the JAX package from ``jax.random``, so the two are compared in
distribution, never draw by draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

from spearmint_tpu.golden import numpy_ref
from spearmint_tpu.mcmc import chains as jchains
from spearmint_tpu.mcmc.slice import slice_sample as jax_slice_sample
from spearmint_tpu_torch.core.likelihood import GPHypers
from spearmint_tpu_torch.engine.suggest import init_chain_states
from spearmint_tpu_torch.mcmc import slice as tslice
from spearmint_tpu_torch.mcmc.chains import (
    MCMCConfig, burnin, marginal_at, sample_hypers, sample_hypers_lp,
)

torch.set_num_threads(1)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _run(logprob, x0, sweeps, seed=0, **kw):
    """[sweeps, K, dim] states of K lockstep chains."""
    gen = _gen(seed)
    x = torch.as_tensor(x0, dtype=torch.float32)
    out = []
    for _ in range(sweeps):
        x, _ = tslice.slice_sample(gen, x, logprob, **kw)
        out.append(x.numpy().copy())
    return np.array(out)


def _std_normal(x):
    return -0.5 * (x * x).sum(-1)


def test_standard_normal_ks():
    """32 chains × 150 sweeps, 50 burned, thinned by 5: KS p > 0.01."""
    xs = _run(_std_normal, np.zeros((32, 1)), 150)[50::5, :, 0]
    _, p = sps.kstest(xs.ravel(), "norm")
    assert p > 0.01, p


def test_exponential_bounded_support():
    """p(x) ∝ exp(−x) on x > 0, the support given as −inf outside; NaN
    outside is treated the same way (it is −inf to the sampler)."""
    for outside in (float("-inf"), float("nan")):
        def logprob(x):
            return torch.where(x[:, 0] > 0, -x[:, 0],
                               torch.full_like(x[:, 0], outside))

        xs = _run(logprob, np.ones((32, 1)), 150, seed=1)[50::5, :, 0]
        assert np.all(xs > 0)
        _, p = sps.kstest(xs.ravel(), "expon")
        assert p > 0.01, (outside, p)


def test_compwise_2d_gaussian_moments():
    cov = np.array([[1.0, 0.6], [0.6, 1.0]], np.float32)
    prec = torch.tensor(np.linalg.inv(cov))

    def logprob(x):
        return -0.5 * ((x @ prec) * x).sum(-1)

    xs = _run(logprob, np.zeros((32, 2)), 200, compwise=True)[50:]
    flat = xs.reshape(-1, 2)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.15)
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.1)


def test_matches_jax_sampler_in_distribution():
    """The same target through the JAX sampler (vmapped chains) and the
    port (lockstep chains): two-sample KS p > 0.01 on a skewed density."""
    def t_lp(x):
        return torch.where(x[:, 0] > 0, 2.0 * torch.log(
            x[:, 0].clamp_min(1e-30)) - x[:, 0], float("-inf"))

    def j_lp(x):
        return jnp.where(x[0] > 0, 2.0 * jnp.log(jnp.maximum(x[0], 1e-30))
                         - x[0], -jnp.inf)

    ours = _run(t_lp, np.ones((32, 1)), 150, seed=2)[50::5, :, 0].ravel()
    step = jax.jit(jax.vmap(lambda k, x: jax_slice_sample(k, x, j_lp)))
    key = jax.random.PRNGKey(0)
    x = jnp.ones((32, 1), jnp.float32)
    theirs = []
    for i in range(150):
        key, k = jax.random.split(key)
        x = step(jax.random.split(k, 32), x)
        if i >= 50 and (i - 50) % 5 == 0:
            theirs.append(np.asarray(x)[:, 0])
    _, p = sps.ks_2samp(ours, np.concatenate(theirs))
    assert p > 0.01, p
    _, p_gamma = sps.kstest(ours, "gamma", args=(3.0,))
    assert p_gamma > 0.01, p_gamma


def test_chains_are_independent():
    xs = _run(_std_normal, np.zeros((8, 1)), 50)
    assert len(np.unique(xs[-1].round(6))) == 8


@pytest.mark.parametrize("compwise", [False, True])
def test_lp0_carry_is_exact(compwise):
    """Passing lp0 = logprob(x0) gives the samples the sampler finds on
    its own (no draw depends on the extra evaluation), and the returned
    lp is the logprob at the returned point."""
    def logprob(x):
        return -1.5 * ((x - 0.7) ** 2).sum(-1)

    x0 = torch.tensor([[0.2, -0.4], [1.0, 0.3], [0.0, 0.0]])
    for seed in range(4):
        a, _ = tslice.slice_sample(_gen(seed), x0, logprob, compwise=compwise)
        b, lp_b = tslice.slice_sample(_gen(seed), x0, logprob,
                                      compwise=compwise, lp0=logprob(x0))
        assert torch.equal(a, b)
        np.testing.assert_allclose(lp_b.numpy(), logprob(b).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_neg_inf_start_skips_expansion():
    """A chain at a −inf point (the finite_slice guard) skips the step-out
    and accepts the first finite proposal of the shrink phase."""
    calls = []

    def logprob(x):
        calls.append(1)
        return torch.where(x[:, 0].abs() < 1e-3, float("-inf"),
                           -x[:, 0] ** 2)

    x, lp = tslice.slice_sample(_gen(3), torch.zeros(1, 1), logprob)
    assert bool(torch.isfinite(lp).all()) and float(x.abs()) >= 1e-3
    # the seed evaluation at x0, then one accepted shrink proposal
    assert len(calls) == 2


def test_exhausted_shrink_stays_put():
    """A density that rejects every proposal: after MAX_SHRINK rejections
    the chain stays at x0 with its density (the reference would raise)."""
    steps = []

    def logprob(x):
        steps.append(1)
        return torch.full_like(x[:, 0], float("-inf"))

    x0 = torch.tensor([[0.3], [0.5]])
    x, lp = tslice.slice_sample(_gen(0), x0, logprob, lp0=torch.zeros(2))
    assert torch.equal(x, x0) and torch.equal(lp, torch.zeros(2))
    # one lower and one upper bracket evaluation, then the shrink budget
    assert len(steps) == 2 + tslice.MAX_SHRINK
    assert (tslice.MAX_STEPS_OUT, tslice.MAX_SHRINK) == (1000, 64)


# ----------------------------------------------------------- GP chains
def _gp_data(n=30, d=2, seed=3, pad=32):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d)
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.05 * rng.randn(n)
    x, y = x.astype(np.float32), (y - y.mean()).astype(np.float32)
    xp = np.zeros((pad, d), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    return x, y, xp, yp, np.arange(pad) < n


def test_sweep_carries_the_marginal():
    """sample_hypers_lp returns the log-marginal at the new state, so the
    next sweep can skip its seed evaluation."""
    _, _, xp, yp, mask = _gp_data()
    xt, yt, mt = torch.tensor(xp), torch.tensor(yp), torch.tensor(mask)
    cfg = MCMCConfig()
    h = init_chain_states(yt, mt, 2, 4)
    lp = marginal_at(xt, yt, mt, h, cfg)
    gen = _gen(5)
    for _ in range(3):
        h, lp = sample_hypers_lp(gen, h, lp, xt, yt, mt, cfg)
        np.testing.assert_allclose(lp.numpy(),
                                   marginal_at(xt, yt, mt, h, cfg).numpy(),
                                   rtol=1e-6)
    h2 = sample_hypers(gen, h, xt, yt, mt, cfg)
    assert all(a.shape == b.shape for a, b in zip(h, h2))
    # band mode runs (pad 32 in blocks of 8): one band reduction per joint
    # move, each move seeding its own lp0
    h3 = sample_hypers(gen, h, xt, yt, mt,
                       MCMCConfig(band_joint=True, band_block=8))
    assert all(a.shape == b.shape and bool(torch.isfinite(b).all())
               for a, b in zip(h, h3))


def test_posterior_moments_match_jax_and_golden():
    """n=30: noise and length scales are tightly identified; amp2 is
    long-tailed.  The JAX package's parity criteria (tests/test_parity.py):
    log-noise medians within log 3, ls medians within 0.4, log-amp2
    medians within log 3.5 and overlapping amp2 IQRs — here for the port
    against the float64 oracle and against the JAX chains."""
    x, y, xp, yp, mask = _gp_data()
    xt, yt, mt = torch.tensor(xp), torch.tensor(yp), torch.tensor(mask)
    chains, sweeps, burn = 16, 55, 20
    cfg = MCMCConfig()

    h = burnin(_gen(0), init_chain_states(yt, mt, 2, chains), xt, yt, mt,
               burn, cfg)
    lp = marginal_at(xt, yt, mt, h, cfg)
    gen = _gen(1)
    port = []
    for _ in range(sweeps - burn):
        h, lp = sample_hypers_lp(gen, h, lp, xt, yt, mt, cfg)
        port.append(GPHypers(*(a.numpy().copy() for a in h)))

    from spearmint_tpu.engine.suggest import init_chain_states as j_init

    xj, yj, mj = jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask)
    hj = j_init(yj, mj, 2, chains)
    step = jax.jit(jax.vmap(lambda k, hh: jchains.sample_hypers(
        k, hh, xj, yj, mj, jchains.MCMCConfig())))
    key = jax.random.PRNGKey(0)
    theirs = []
    for i in range(sweeps):
        key, k = jax.random.split(key)
        hj = step(jax.random.split(k, chains), hj)
        if i >= burn:
            theirs.append(jax.tree.map(np.asarray, hj))

    gp = numpy_ref.GoldenGP(2, y, seed=0)
    gold = [gp.sample_hypers(x.astype(float), y.astype(float))
            for _ in range(700)][150:]
    g = dict(amp2=np.array([s[1] for s in gold]),
             noise=np.array([s[2] for s in gold]),
             ls=np.array([s[3] for s in gold]))

    def pool(samples):
        return dict(amp2=np.concatenate([s.amp2 for s in samples]),
                    noise=np.concatenate([s.noise for s in samples]),
                    ls=np.concatenate([s.ls.reshape(-1, 2)
                                       for s in samples]))

    ours = pool(port)
    for ref in (g, pool(theirs)):
        assert abs(np.log(np.median(ours["noise"]))
                   - np.log(np.median(ref["noise"]))) < np.log(3)
        np.testing.assert_allclose(np.median(ours["ls"], 0),
                                   np.median(ref["ls"], 0), atol=0.4)
        assert abs(np.log(np.median(ours["amp2"]))
                   - np.log(np.median(ref["amp2"]))) < np.log(3.5)
        o_lo, o_hi = np.percentile(ours["amp2"], [25, 75])
        r_lo, r_hi = np.percentile(ref["amp2"], [25, 75])
        assert o_lo < r_hi and r_lo < o_hi
