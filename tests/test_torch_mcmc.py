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


# ------------------------------------------------------ loop counters
def _counting(fn):
    """fn and the list that gets one entry per batched call of it."""
    calls = []

    def wrapped(x):
        calls.append(1)
        return fn(x)

    return wrapped, calls


def _lockstep(counts, stepped_out):
    """Calls a sweep's batched loops make by the identity of
    ``slice.move_evals``: max over chains of each move's evaluations,
    summed over the moves (counts [K, 3] or [K, D, 3])."""
    evals = tslice.move_evals(counts, stepped_out)
    if evals.ndim == 1:
        evals = evals[:, None]
    return int(evals.max(0).values.sum())


@pytest.mark.parametrize("compwise", [False, True])
@pytest.mark.parametrize("with_lp0", [False, True])
def test_counts_are_the_loops_own_record(compwise, with_lp0):
    """Counts of a sweep from finite starts: the batched logprob calls
    equal Σ over moves of max over chains (lo + up + sh + 2), plus one
    seed evaluation when lp0 is not given; the layout is the JAX
    sampler's ([K, 3] joint, [K, D, 3] compwise)."""
    def lp_fn(x):
        return -1.5 * ((x - 0.7) ** 2).sum(-1) - (x[:, 0] * x[:, -1]) ** 2

    x0 = torch.tensor([[0.2, -0.4, 0.1], [1.0, 0.3, 2.0], [0.0, 0.0, 0.0],
                       [3.0, -1.0, 0.5]])
    for seed in range(5):
        logprob, calls = _counting(lp_fn)
        lp0 = lp_fn(x0) if with_lp0 else None
        _, lp, counts = tslice.slice_sample(
            _gen(seed), x0, logprob, compwise=compwise, lp0=lp0,
            with_counts=True)
        assert counts.dtype == torch.int32
        assert counts.shape == ((4, 3, 3) if compwise else (4, 3))
        seed_evals = 0 if with_lp0 else 1
        assert len(calls) == _lockstep(counts, True) + seed_evals, seed


@pytest.mark.parametrize("with_lp0", [False, True])
def test_counts_of_chains_that_start_at_neg_inf(with_lp0):
    """A chain at a −inf point does not step out: its move's evaluations
    are its shrink count alone, and the batch's calls still follow the
    identity with those chains marked as not stepped out."""
    def lp_fn(x):
        return torch.where(x[:, 0].abs() < 1e-3, float("-inf"),
                           -(x ** 2).sum(-1))

    x0 = torch.tensor([[0.0, 0.5], [0.8, 0.1], [0.0, -0.3], [-0.4, 0.2]])
    started = torch.isfinite(lp_fn(x0))
    assert started.tolist() == [False, True, False, True]
    for seed in range(5):
        logprob, calls = _counting(lp_fn)
        _, lp, counts = tslice.slice_sample(
            _gen(seed), x0, logprob, lp0=lp_fn(x0) if with_lp0 else None,
            with_counts=True)
        assert bool((counts[~started, :2] == 0).all())
        assert len(calls) == (_lockstep(counts, started)
                              + (0 if with_lp0 else 1)), seed


@pytest.mark.parametrize("compwise", [False, True])
def test_counts_off_means_unchanged(compwise):
    """with_counts changes neither the draws nor the result: the states,
    the densities and the generator's state after the sweep are bit for
    bit those of the same sweep without it."""
    def logprob(x):
        return -1.5 * ((x - 0.7) ** 2).sum(-1)

    x0 = torch.tensor([[0.2, -0.4], [1.0, 0.3], [0.0, 0.0]])
    for seed in range(4):
        g_off, g_on = _gen(seed), _gen(seed)
        x_off, lp_off = tslice.slice_sample(g_off, x0, logprob,
                                            compwise=compwise)
        x_on, lp_on, _ = tslice.slice_sample(g_on, x0, logprob,
                                             compwise=compwise,
                                             with_counts=True)
        assert torch.equal(x_off, x_on) and torch.equal(lp_off, lp_on)
        assert torch.equal(g_off.get_state(), g_on.get_state())


def test_sweep_counts_are_the_marginals_own_record():
    """sample_hypers_lp's counters: the GP marginal evaluations of a
    carried sweep equal the joint move's and each ls move's lockstep
    evaluations (no seed evaluation: the carry gives lp0), and the states
    equal those of the sweep without counters."""
    _, _, xp, yp, mask = _gp_data()
    xt, yt, mt = torch.tensor(xp), torch.tensor(yp), torch.tensor(mask)
    marginal, calls = _counting(None)
    base = MCMCConfig()

    def counted(*a, **kw):
        calls.append(1)
        return base.marginal(*a, **kw)

    cfg = MCMCConfig(marginal=counted)
    h0 = init_chain_states(yt, mt, 2, 6)
    lp0 = marginal_at(xt, yt, mt, h0, base)
    g_on, g_off = _gen(7), _gen(7)
    h_on, lp_on, h_off, lp_off = h0, lp0, h0, lp0
    for _ in range(4):
        calls.clear()
        assert bool(torch.isfinite(lp_on).all())
        h_on, lp_on, (c_joint, c_ls) = sample_hypers_lp(
            g_on, h_on, lp_on, xt, yt, mt, cfg, with_counts=True)
        assert c_joint.shape == (6, 3) and c_ls.shape == (6, 2, 3)
        assert len(calls) == _lockstep(c_joint, True) + _lockstep(c_ls, True)
        h_off, lp_off = sample_hypers_lp(g_off, h_off, lp_off, xt, yt, mt,
                                         base)
        assert all(torch.equal(a, b) for a, b in zip(h_on, h_off))
        assert torch.equal(lp_on, lp_off)


def _jax_sweep_counts(xp, yp, mask, chains, sweeps, seed):
    """The JAX package's counters over ``sweeps`` carried sweeps from the
    reference-init states, threaded by hand as bin/profile_slice_counts.py
    does: (joint [S, K, 3], ls [S, K, D, 3], started finite [S, K])."""
    from spearmint_tpu.engine.suggest import init_chain_states as j_init

    xj, yj, mj = jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask)
    mcfg = jchains.MCMCConfig()

    def one(k, hh, lp0):
        k_joint, k_ls = jax.random.split(k)
        vec0 = jnp.stack([hh.mean, hh.amp2, hh.noise])
        vec, lp_joint, c_joint = jax_slice_sample(
            k_joint, vec0,
            lambda v: jchains._joint_logprob(v, xj, yj, mj, hh.ls, mcfg),
            compwise=False,
            lp0=lp0 + jchains._joint_prior_terms(hh.amp2, hh.noise, mcfg),
            with_lp=True, with_counts=True)
        mid = jchains.GPHypers(vec[0], vec[1], vec[2], hh.ls)
        ls, lp_ls, c_ls = jax_slice_sample(
            k_ls, hh.ls,
            lambda ls: jchains._ls_logprob(ls, xj, yj, mj, mid, mcfg),
            compwise=True,
            lp0=lp_joint - jchains._joint_prior_terms(vec[1], vec[2], mcfg),
            with_lp=True, with_counts=True)
        return (jchains.GPHypers(vec[0], vec[1], vec[2], ls), lp_ls,
                c_joint, c_ls)

    sweep = jax.jit(lambda k, h, lp: jax.vmap(one)(
        jax.random.split(k, chains), h, lp))
    h = j_init(yj, mj, xp.shape[1], chains)
    lp = jax.jit(jax.vmap(
        lambda hh: jchains.marginal_at(xj, yj, mj, hh, mcfg)))(h)
    key = jax.random.PRNGKey(seed)
    cj, cl, fin = [], [], []
    for _ in range(sweeps):
        key, k = jax.random.split(key)
        fin.append(np.isfinite(np.asarray(lp)))
        h, lp, c_joint, c_ls = sweep(k, h, lp)
        cj.append(np.asarray(c_joint))
        cl.append(np.asarray(c_ls))
    return np.stack(cj), np.stack(cl), np.stack(fin)


def _evals_match_jax(x, y, sweeps=20):
    """Evaluations per move of the port's sweeps (the slice-count tool's
    ``collect``) and the JAX package's on the same data: two-sample KS on
    the joint move's and on the ls moves' per-chain evaluations, each
    p > 0.01 (the threshold of tests/test_slice.py).  Returns both
    packages' means."""
    from spearmint_tpu_torch.core.linalg import pad_bucket
    from spearmint_tpu_torch.tools import profile_slice_counts as tool

    n, d = x.shape
    pad = pad_bucket(n)
    xp = np.zeros((pad, d), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    ours = tool.collect(sweeps, x, y, device="cpu")
    chains = tool.CHAINS
    theirs = _jax_sweep_counts(xp, yp, np.arange(pad) < n, chains, sweeps,
                               seed=0)
    means = {}
    for pkg, (cj, cl, fin) in (("port", ours), ("jax", theirs)):
        assert cj.shape == (sweeps, chains, 3)
        assert cl.shape == (sweeps, chains, d, 3)
        assert fin.all(), pkg     # every move stepped out
        stats = tool.summarize(cj, cl, fin)
        means[pkg] = {"joint": (cj.sum(-1) + 2).ravel(),
                      "ls": (cl.sum(-1) + 2).ravel(),
                      "lockstep_mean": stats["lockstep_mean"]}
    for move in ("joint", "ls"):
        _, p = sps.ks_2samp(means["port"][move], means["jax"][move])
        assert p > 0.01, (move, p, means["port"][move].mean(),
                          means["jax"][move].mean())
    return {pkg: {k: float(np.mean(v)) for k, v in m.items()}
            for pkg, m in means.items()}


def test_counts_match_jax_in_distribution():
    """n=96 of the flagship's synthetic data, 10 chains, 20 sweeps."""
    from spearmint_tpu_torch.tools.profile_slice_counts import make_problem

    x, y = make_problem(96, 2)
    print(_evals_match_jax(x.astype(np.float32), y.astype(np.float32)))


@pytest.mark.slow
def test_counts_match_jax_at_the_harness_branin_data():
    """The sync harness's n=450 Branin completions (pad 512, the pad from
    which the card runs B1), 10 chains, 4 sweeps.  Slow: the joint move
    steps out 400-600 times a sweep on the raw Branin values, and the
    plain blocked factorization at pad 512 takes 0.2 s an evaluation on
    one CPU thread (about 8 minutes for the port's sweeps)."""
    from spearmint_tpu_torch.tools.profile_slice_counts import branin_problem

    x, y = branin_problem(450)
    print(_evals_match_jax(x.astype(np.float32), y.astype(np.float32),
                           sweeps=4))
