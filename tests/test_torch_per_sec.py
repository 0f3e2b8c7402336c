"""EI per second: the port's ``engine/per_sec`` and ``GPEIperSecChooser``
against the JAX package's.

Everything downstream of fixed hyperparameters (both families' caches,
EI, the duration posterior, EI/sec) is held element by element to the JAX
step and to the float64 oracle; the chains differ in their random streams
(``torch.Generator`` against ``jax.random``), so the sampled duration
family is held in distribution.  Two reference defects are decided in the
port and pinned here: the missing finite filter, and the chain states kept
after a sweep in which every sample failed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spearmint_tpu.core.likelihood import GPHypers as JHypers
from spearmint_tpu.engine.suggest import SuggestConfig as JConfig
from spearmint_tpu.golden import numpy_ref as g
from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.core.likelihood import GPHypers
from spearmint_tpu_torch.engine import per_sec as ps
from spearmint_tpu_torch.engine.suggest import (
    SuggestConfig, init_chain_states,
)

torch.set_num_threads(1)

ARGS = "mcmc_iters=3,chains=3,burnin=10,grid_subset=3,lbfgs_iters=8"


def _problem(rng, n=16):
    """tests/test_per_sec.py's: EI symmetric in x0, duration rising in x0."""
    x = rng.rand(n, 2).astype(np.float32)
    y = (10 * (x[:, 1] - 0.5) ** 2 + 0.05 * rng.randn(n)).astype(np.float32)
    log_d = (5.0 * x[:, 0]).astype(np.float32)
    return x, y, log_d


def _step(h, t, x, y, log_d, mask, cand, cfg, pend=None, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    p = np.zeros((4, 2), np.float32) if pend is None else pend
    return ps.suggest_step_per_sec(
        gen, h, t, x, y, log_d, mask, p, np.arange(4) < (
            0 if pend is None else len(pend)), cand, np.ones(len(cand), bool),
        cfg, device="cpu")


def _fixed_state_data():
    rng = np.random.RandomState(4)
    n, pad, d, c = 14, 16, 2, 64
    x = rng.rand(n, d)
    y = np.sin(4 * x[:, 0]) + 0.1 * rng.randn(n)
    log_d = 2.0 * x[:, 1] + 0.05 * rng.randn(n)
    cand = rng.rand(c, d)
    hv = [dict(mean=float(y.mean()), amp2=1.2, noise=2e-3,
               ls=np.array([0.7, 0.4])),
          dict(mean=0.1, amp2=0.7, noise=1e-2, ls=np.array([0.5, 0.9]))]
    ht = [dict(mean=float(log_d.mean()), amp2=0.8, noise=1e-3,
               ls=np.array([1.1, 0.6])),
          dict(mean=0.5, amp2=1.5, noise=5e-3, ls=np.array([0.4, 0.8]))]
    xp = np.zeros((pad, d), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    tp = np.zeros(pad, np.float32); tp[:n] = log_d
    return x, y, log_d, cand, hv, ht, xp, yp, tp, np.arange(pad) < n


def _stack(hs, cls, arr):
    return cls(*(arr(np.array([h[k] for h in hs], np.float32))
                 for k in ("mean", "amp2", "noise", "ls")))


def test_ei_per_sec_at_a_fixed_dual_state_matches_jax_and_golden(
        monkeypatch):
    """Both samplers held still (two lanes, each family at its own fixed
    state): the port's step gives the JAX step's EI/sec element by element
    (the tolerance of tests/test_torch_acquire.py) and the float64
    ``compute_ei / max(exp(posterior mean), 1e-3)``, averaged over the
    lanes."""
    import spearmint_tpu.engine.per_sec as jps

    x, y, log_d, cand, hv, ht, xp, yp, tp, mask = _fixed_state_data()
    monkeypatch.setattr(ps, "_sample_chains",
                        lambda gen, h, *a: (h, h))
    monkeypatch.setattr(jps, "sample_hypers_lp",
                        lambda k, h, lp, *a: (h, lp))
    # a jit of its own, so no trace of another test is reused
    jstep = jax.jit(jps.suggest_step_per_sec.__wrapped__,
                    static_argnames=("config",))
    want = jstep(
        jax.random.PRNGKey(0), _stack(hv, JHypers, jnp.asarray),
        _stack(ht, JHypers, jnp.asarray), jnp.asarray(xp), jnp.asarray(yp),
        jnp.asarray(tp), jnp.asarray(mask), jnp.zeros((4, 2)),
        jnp.zeros(4, bool), jnp.asarray(cand, jnp.float32),
        jnp.ones(len(cand), bool), JConfig(mcmc_iters=1, optimize=False))
    for with_inverse in (True, False):
        got = _step(_stack(hv, GPHypers, torch.tensor),
                    _stack(ht, GPHypers, torch.tensor), xp, yp, tp, mask,
                    cand.astype(np.float32),
                    SuggestConfig(mcmc_iters=1, optimize=False,
                                  explicit_inverse=with_inverse))
        assert int(got.n_ok) == 2 == int(want.n_ok)
        np.testing.assert_allclose(got.ei_per_s.numpy(),
                                   np.asarray(want.ei_per_s),
                                   rtol=1e-3, atol=1e-5)
        assert int(got.best_cand) == int(want.best_cand)

    gold = np.mean([g.compute_ei(x, y, cand, **a)
                    / np.maximum(np.exp(g.posterior(x, log_d, cand, **b)[0]),
                                 1e-3) for a, b in zip(hv, ht)], 0)
    np.testing.assert_allclose(got.ei_per_s.numpy(), gold, rtol=3e-3,
                               atol=3e-4 * np.abs(gold).max())


def test_per_sec_prefers_cheap_side():
    rng = np.random.RandomState(0)
    x, y, log_d = _problem(rng)
    mask = np.ones(16, bool)
    cand = rng.rand(64, 2).astype(np.float32)
    h = init_chain_states(torch.tensor(y), torch.tensor(mask), 2, 4)
    t = init_chain_states(torch.tensor(log_d), torch.tensor(mask), 2, 4)
    res = _step(h, t, x, y, log_d, mask, cand,
                SuggestConfig(mcmc_iters=3, optimize=False))
    ei_ps = res.ei_per_s.numpy()
    assert np.all(np.isfinite(ei_ps)) and int(res.n_ok) == 12
    left = ei_ps[cand[:, 0] < 0.4].mean()
    right = ei_ps[cand[:, 0] > 0.6].mean()
    assert left > 3 * right, (left, right)
    assert cand[int(res.best_cand), 0] < 0.5
    # the two families sample their own states
    assert not torch.equal(res.time_samples.ls, res.samples.ls)


def test_per_sec_chunked_matches_unchunked(monkeypatch):
    """chain_chunk and explicit_inverse apply to both families and must
    not change the acquisition.  One torch.Generator's draws depend on
    how the chains are grouped, so the samplers are held still (each lane
    at its own state) and the rest of the step runs in groups of 2 against
    one batch: the JAX test's 2e-4 relative."""
    rng = np.random.RandomState(2)
    x, y, log_d = _problem(rng)
    mask = np.ones(16, bool)
    cand = rng.rand(32, 2).astype(np.float32)
    h = init_chain_states(torch.tensor(y), torch.tensor(mask), 2, 4)
    t = init_chain_states(torch.tensor(log_d), torch.tensor(mask), 2, 4)
    h = h._replace(ls=torch.tensor(rng.uniform(0.3, 1.0, (4, 2)),
                                   dtype=torch.float32))
    t = t._replace(ls=torch.tensor(rng.uniform(0.3, 1.0, (4, 2)),
                                   dtype=torch.float32))
    monkeypatch.setattr(ps, "_sample_chains", lambda gen, hh, *a: (hh, hh))
    base, chunked = (
        _step(h, t, x, y, log_d, mask, cand,
              SuggestConfig(mcmc_iters=1, grid_subset=3, lbfgs_iters=5, **kw))
        for kw in (dict(), dict(chain_chunk=2, explicit_inverse=False)))
    np.testing.assert_allclose(base.ei_per_s.numpy(),
                               chunked.ei_per_s.numpy(), rtol=2e-4,
                               atol=1e-7)
    assert int(base.best_cand) == int(chunked.best_cand)
    np.testing.assert_allclose(float(base.ei_opt), float(chunked.ei_opt),
                               rtol=1e-3)


def test_per_sec_with_pending_fantasies_is_finite():
    rng = np.random.RandomState(4)
    x, y, log_d = _problem(rng)
    mask = np.ones(16, bool)
    cand = rng.rand(32, 2).astype(np.float32)
    pend = rng.rand(4, 2).astype(np.float32)
    h = init_chain_states(torch.tensor(y), torch.tensor(mask), 2, 4)
    t = init_chain_states(torch.tensor(log_d), torch.tensor(mask), 2, 4)
    res = _step(h, t, x, y, log_d, mask, cand,
                SuggestConfig(mcmc_iters=2, grid_subset=3, lbfgs_iters=5,
                              has_pending=True, n_fantasies=5,
                              chain_chunk=2), pend=pend)
    assert np.all(np.isfinite(res.ei_per_s.numpy()))
    assert int(res.n_ok) == 8 and bool(torch.isfinite(res.x_opt).all())


def _chooser_problem(rng):
    grid = rng.rand(40, 2)
    values = np.full(40, np.nan)
    durs = np.full(40, np.nan)
    complete = np.arange(10)
    values[complete] = rng.randn(10)
    durs[complete] = np.exp(2 * grid[complete, 0])
    return grid, values, durs, np.arange(10, 40), complete


def test_per_sec_chooser_protocol(tmp_path):
    grid, values, durs, candidates, complete = _chooser_problem(
        np.random.RandomState(1))
    chooser = get_chooser("GPEIperSecChooser", str(tmp_path),
                          ARGS + ",device=cpu")
    out = chooser.next(grid, values, durs, candidates, [], complete)
    if isinstance(out, tuple):
        assert out[1].shape == (2,) and 0 <= out[1].min() <= out[1].max() <= 1
    else:
        assert isinstance(out, int) and out in candidates
    with np.load(os.path.join(str(tmp_path),
                              "GPEIperSecChooser_state.npz")) as z:
        assert z["time_ls"].shape == (3, 2) and z["ls"].shape == (3, 2)
        assert int(z["key_state"]) == 1 and bool(z["burned_in"])
    ev = [e for e in chooser.events.read() if e["kind"] == "suggest"][-1]
    assert ev["n_ok"] == 3 and ev["device"] == "cpu"
    # pending jobs take the fantasy branch
    out = chooser.next(grid, values, durs, candidates[2:], candidates[:2],
                       complete)
    assert isinstance(out, (int, tuple))
    assert [e for e in chooser.events.read()
            if e["kind"] == "suggest"][-1]["n_pending"] == 2


def test_per_sec_state_resumes_across_packages(tmp_path):
    """The JAX chooser's state file resumes in the port, which continues
    from it, and the port's file resumes in the JAX chooser (same keys,
    values and dtypes), which continues from it too."""
    from spearmint_tpu.choosers.GPEIperSecChooser import (
        GPEIperSecChooser as JaxChooser,
    )

    expt = str(tmp_path)
    rng = np.random.RandomState(0)

    def rand_hypers():
        return JHypers(
            jnp.asarray(rng.uniform(-1, 1, 3), jnp.float32),
            jnp.asarray(rng.uniform(0.5, 2, 3), jnp.float32),
            jnp.asarray(rng.uniform(1e-3, 0.1, 3), jnp.float32),
            jnp.asarray(rng.uniform(0.3, 1.5, (3, 2)), jnp.float32))

    jc = JaxChooser(expt, chains=3, mcmc_iters=3, grid_subset=3,
                    lbfgs_iters=8)
    jc._hypers, jc._time_hypers = rand_hypers(), rand_hypers()
    jc._key_state, jc._burned_in = 5, True
    jc._save_state()

    pc = get_chooser("GPEIperSecChooser", expt, ARGS + ",device=cpu")
    pc._load_state(2)
    for a, b in zip((*pc._hypers, *pc._time_hypers),
                    (*jc._hypers, *jc._time_hypers)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pc._key_state == 5 and pc._burned_in
    grid, values, durs, candidates, complete = _chooser_problem(
        np.random.RandomState(1))
    pc.next(grid, values, durs, candidates, [], complete)
    assert pc._key_state == 6

    with np.load(os.path.join(expt, "GPEIperSecChooser_state.npz")) as z:
        assert sorted(z.files) == [
            "amp2", "burned_in", "key_state", "ls", "mean", "noise",
            "time_amp2", "time_ls", "time_mean", "time_noise"]
        assert all(z[k].dtype == np.float32 for k in z.files
                   if k not in ("burned_in", "key_state"))
    jc2 = JaxChooser(expt, chains=3, mcmc_iters=3, grid_subset=3,
                     lbfgs_iters=8)
    jc2._load_state(2)
    for a, b in zip((*jc2._hypers, *jc2._time_hypers),
                    (*pc._hypers, *pc._time_hypers)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jc2._key_state == 6 and jc2._burned_in
    out = jc2.next(grid, values, durs, candidates, [], complete)
    assert isinstance(out, (int, tuple)) and jc2._key_state == 7


def test_one_nan_completion_degenerates_jax_but_not_the_port(tmp_path):
    """Reference defect (GPEIperSecChooser.py:92): the JAX chooser takes
    values[complete] without the finite filter, so one NaN completion
    makes every sample fail and it returns candidates[0] with a
    suggest_degenerate event.  The port drops the NaN completion with its
    duration and input, as the flagship does, and suggests."""
    from spearmint_tpu.choosers.GPEIperSecChooser import (
        GPEIperSecChooser as JaxChooser,
    )

    grid, values, durs, candidates, complete = _chooser_problem(
        np.random.RandomState(1))
    values[complete[3]] = np.nan
    os.makedirs(tmp_path / "jax")
    jc = JaxChooser(str(tmp_path / "jax"), chains=3, mcmc_iters=3,
                    burnin=10, grid_subset=3, lbfgs_iters=8)
    assert jc.next(grid, values, durs, candidates, [],
                   complete) == int(candidates[0])
    assert "suggest_degenerate" in [e["kind"] for e in jc.events.read()]

    os.makedirs(tmp_path / "port")
    pc = get_chooser("GPEIperSecChooser", str(tmp_path / "port"),
                     ARGS + ",device=cpu")
    out = pc.next(grid, values, durs, candidates, [], complete)
    kinds = [e["kind"] for e in pc.events.read()]
    assert "suggest_degenerate" not in kinds
    ev = [e for e in pc.events.read() if e["kind"] == "suggest"][-1]
    assert ev["n_ok"] == 3 and ev["n_obs"] == 9
    if not isinstance(out, tuple):
        assert out in candidates and out != int(candidates[0])


def test_degenerate_suggestion_keeps_both_chain_families(tmp_path,
                                                         monkeypatch):
    """n_ok == 0: grid order, a suggest_degenerate event, neither the
    value nor the duration chain states replaced (the JAX chooser saves
    both), and the key advances."""
    from spearmint_tpu_torch.choosers import GPEIperSecChooser as mod

    grid, values, durs, candidates, complete = _chooser_problem(
        np.random.RandomState(3))
    chooser = mod.GPEIperSecChooser(str(tmp_path), chains=2, mcmc_iters=2,
                                    burnin=2, grid_subset=3, lbfgs_iters=5,
                                    device="cpu")
    chooser.next(grid, values, durs, candidates, [], complete)
    before = [a.clone() for a in (*chooser._hypers, *chooser._time_hypers)]
    real = ps.suggest_step_per_sec

    def failed(*a, **k):
        return real(*a, **k)._replace(n_ok=torch.tensor(0))

    monkeypatch.setattr(ps, "suggest_step_per_sec", failed)
    assert chooser.next(grid, values, durs, candidates, [],
                        complete) == int(candidates[0])
    assert "suggest_degenerate" in [e["kind"] for e in chooser.events.read()]
    for a, b in zip((*chooser._hypers, *chooser._time_hypers), before):
        assert torch.equal(a, b)
    with np.load(str(tmp_path / "GPEIperSecChooser_state.npz")) as z:
        np.testing.assert_array_equal(z["ls"], before[3].numpy())
        np.testing.assert_array_equal(z["time_ls"], before[7].numpy())
        assert int(z["key_state"]) == 2


def test_log_durations_clamp_as_jax():
    from spearmint_tpu_torch.choosers.GPEIperSecChooser import log_durations

    d = np.array([np.nan, 0.0, 1e-5, 0.5, 20.0])
    want = np.log(np.maximum(np.nan_to_num(d, nan=1.0), 1e-3))
    np.testing.assert_array_equal(log_durations(d),
                                  want.astype(np.float32))


@pytest.mark.slow
def test_duration_chains_match_jax_in_distribution(tmp_path):
    """The duration family as the choosers sample it: over seeds 0-2, each
    chooser (8 chains, burn-in 20) makes three suggestions on one history
    whose durations follow exp(2·x0), and its duration chain states after
    each are pooled.  The two pools must agree as tests/test_parity.py
    holds chains to the oracle: log-amp2 medians within log 3.5 with
    overlapping IQRs, ls medians within 0.4.  About 26 s on one CPU
    thread, most of it the JAX chooser's compiles: marked slow."""
    from spearmint_tpu.choosers.GPEIperSecChooser import (
        GPEIperSecChooser as JaxChooser,
    )

    rng = np.random.RandomState(8)
    grid = rng.rand(48, 2)
    values = np.full(48, np.nan)
    durs = np.full(48, np.nan)
    complete = np.arange(16)
    values[complete] = np.sin(3 * grid[complete, 1]) + 0.05 * rng.randn(16)
    durs[complete] = np.exp(2 * grid[complete, 0] + 0.05 * rng.randn(16))
    candidates = np.arange(16, 48)
    args = dict(chains=8, mcmc_iters=8, burnin=20, grid_subset=2,
                lbfgs_iters=2)
    pools = {"port": [], "jax": []}
    for seed in range(3):
        for name in pools:
            expt = str(tmp_path / f"{name}{seed}")
            os.makedirs(expt)
            if name == "port":
                ch = get_chooser("GPEIperSecChooser", expt, ",".join(
                    f"{k}={v}" for k, v in args.items())
                    + f",seed={seed},device=cpu")
            else:
                ch = JaxChooser(expt, seed=seed, **args)
            for _ in range(3):
                ch.next(grid, values, durs, candidates, [], complete)
                t = ch._time_hypers
                pools[name].append((np.asarray(t.amp2).copy(),
                                    np.asarray(t.ls).copy()))
    amp2 = {k: np.concatenate([a for a, _ in v]) for k, v in pools.items()}
    ls = {k: np.concatenate([b for _, b in v]) for k, v in pools.items()}
    assert abs(np.log(np.median(amp2["port"]))
               - np.log(np.median(amp2["jax"]))) < np.log(3.5)
    o_lo, o_hi = np.percentile(amp2["port"], [25, 75])
    r_lo, r_hi = np.percentile(amp2["jax"], [25, 75])
    assert o_lo < r_hi and r_lo < o_hi
    np.testing.assert_allclose(np.median(ls["port"], 0),
                               np.median(ls["jax"], 0), atol=0.4)
