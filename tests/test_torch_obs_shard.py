"""Observation-sharded GP primitives and suggestions: the port's
``engine/obs_shard`` on gloo ranks against the JAX package's on its obs
mesh, and against the port's own unsharded step.

The ranks are processes started from this file (its ``__main__``), one
spawn per world size (2 and 4), each rank on the CPU with one thread,
joined through a FileStore; every rank runs every check once and writes
its results to an npz, which the tests read.  The JAX side runs here, in
the test process, on ``obs_shard.make_obs_mesh(n_devices=W)`` over the
conftest's 8 virtual CPU devices.  The checks are those of
``tests/test_obs_shard.py``, one for one, at its tolerances; beside them,
every rank's results must be equal bit for bit (the sampler branches on
the log-marginal, so the ranks make the same collective calls only if
they agree).
"""

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 150
CHAINS, ITERS = 4, 2
HYP = dict(mean=0.1, amp2=0.8, noise=1e-2, ls=[0.4, 0.7, 1.1])
CHOOSER_ARGS = "mcmc_iters=2,chains=2,obs_shard_min=32,device=cpu"


def _problem():
    """tests/test_obs_shard.py's: 50 points padded to 64, D=3."""
    rng = np.random.RandomState(3)
    n_true, n, d = 50, 64, 3
    x = np.zeros((n, d), np.float32)
    x[:n_true] = rng.rand(n_true, d)
    y = np.zeros(n, np.float32)
    y[:n_true] = np.sin(3 * x[:n_true, 0]) + 0.1 * rng.randn(n_true)
    return x, y, np.arange(n) < n_true


def _cands(seed, c, d=3):
    return np.random.RandomState(seed).rand(c, d).astype(np.float32)


def _log_durs(mask):
    rng = np.random.RandomState(6)
    return np.where(mask, 1.0 + rng.rand(len(mask)), 0.0).astype(np.float32)


def _chooser_history():
    rng = np.random.RandomState(0)
    grid = rng.rand(80, 2)
    values = np.full(80, np.nan)
    durations = np.full(80, np.nan)
    complete = np.arange(30)   # pad 32, a multiple of 2 and of 4 ranks
    values[complete] = np.sin(3 * grid[complete, 0])
    durations[complete] = 1.0 + grid[complete, 1]
    return grid, values, durations, np.arange(30, 80), complete


# --------------------------------------------------------------- the ranks
def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _hyp_t():
    from spearmint_tpu_torch.core.likelihood import GPHypers

    return GPHypers(_t([HYP["mean"]]), _t([HYP["amp2"]]), _t([HYP["noise"]]),
                    _t([HYP["ls"]]))


def _chains(y, mask, d, chains=CHAINS):
    from spearmint_tpu_torch.engine.suggest import init_chain_states

    return init_chain_states(_t(y), _t(mask, torch.bool), d, chains)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _save_result(out, prefix, res, fields):
    for f in fields:
        v = getattr(res, f)
        if hasattr(v, "_asdict"):
            for k, a in v._asdict().items():
                out[f"{prefix}.{f}.{k}"] = a.numpy()
        else:
            out[f"{prefix}.{f}"] = v.numpy()


def _run_chooser(name, expt, out, prefix):
    from spearmint_tpu_torch.choosers import get_chooser
    from spearmint_tpu_torch.utils.events import EventLog

    grid, values, durations, cands, complete = _chooser_history()
    ch = get_chooser(name, expt, CHOOSER_ARGS + ",burnin=3")
    picks = [ch.next(grid, values, durations, cands, [], complete),
             ch.next(grid, values, durations, cands[1:], [int(cands[0])],
                     complete)]
    # a grid index, or an off-grid (value, point) in exact float reprs
    out[prefix + ".picks"] = np.array([
        str(p) if isinstance(p, int)
        else repr((float(p[0]), [float(v) for v in p[1]])) for p in picks])
    modes = [e["mode"] for e in EventLog(expt).read()
             if e["kind"] == "suggest"]
    out[prefix + ".modes"] = np.array(modes)


def rank_main(rank, world, store, out_path, tmp):
    from spearmint_tpu_torch.engine import distributed, obs_shard
    from spearmint_tpu_torch.engine.suggest import SuggestConfig

    torch.set_num_threads(1)
    distributed.initialize(f"file://{store}", world, rank, backend="gloo",
                           timeout=datetime.timedelta(seconds=120))
    mesh = obs_shard.make_obs_mesh(device="cpu")
    x, y, mask = _problem()
    xt, yt, mt = _t(x), _t(y), _t(mask, torch.bool)
    h = _hyp_t()
    out = {"world": np.array(distributed.world_size()),
           "coordinator": np.array(distributed.is_coordinator())}

    a_col = obs_shard.cov_colblock(mesh, xt, mt, h.amp2, h.noise, h.ls)
    l_col = obs_shard.cholesky_colblock(mesh, a_col)
    resid = torch.where(mt, yt - h.mean[:, None], 0.0)
    z = obs_shard.solve_colblock(mesh, l_col, resid)
    out.update(a_col=a_col[0].numpy(), l_col=l_col[0].numpy(),
               z=z[0].numpy(),
               w=obs_shard._backsolve(mesh, l_col, z)[0].numpy())
    out["lp"] = obs_shard.sharded_logprob(mesh)(xt, yt, mt, *h).numpy()
    mu, var = obs_shard.sharded_posterior(mesh)(xt, yt, mt, _t(_cands(11, 17)),
                                                *h)
    out.update(mu=mu[0].numpy(), var=var[0].numpy())

    h0 = _chains(y, mask, 3, chains=1)
    swept = obs_shard.sharded_sample_hypers(mesh)(_gen(42), h0, xt, yt, mt)
    out.update({f"sweep.{k}": v.numpy() for k, v in swept._asdict().items()})

    cfg = SuggestConfig(mcmc_iters=ITERS, optimize=False)
    step = obs_shard.sharded_suggest_obs(mesh, cfg)
    cand = _cands(5, 100)
    res = step(_gen(7), _chains(y, mask, 3), xt, yt, mt, cand,
               np.ones(100, bool))
    _save_result(out, "obs", res, ("hypers", "samples", "ei", "best_cand",
                                   "n_ok"))
    hp = _chains(y, mask, 3)
    hp = hp._replace(amp2=hp.amp2.index_fill(0, torch.tensor([0]),
                                             float("inf")))
    res = step(_gen(11), hp, xt, yt, mt, _cands(9, 64), np.ones(64, bool))
    _save_result(out, "nan", res, ("ei", "best_cand", "n_ok"))

    ld = _log_durs(mask)
    res = obs_shard.sharded_suggest_per_sec(mesh, cfg)(
        _gen(13), _chains(y, mask, 3), _chains(ld, mask, 3), xt, yt, ld, mt,
        _cands(6, 64), np.ones(64, bool))
    _save_result(out, "ps", res, ("hypers", "time_hypers", "ei_per_s",
                                  "best_cand", "n_ok"))

    for name in ("GPEIOptChooser", "GPEIperSecChooser"):
        expt = os.path.join(tmp, name)
        os.makedirs(expt, exist_ok=True)
        _run_chooser(name, expt, out, name)
    np.savez(out_path, **out)


# ------------------------------------------------------- the test process
def _spawn(tmp_path, world):
    """Start the ranks, wait for all of them within RANK_TIMEOUT_S (each
    one's output to a log file, so none can block on a full pipe), stop
    every one still running, and return each rank's results."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(store), str(tmp_path / f"rank{r}.npz"), str(tmp_path)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=REPO)
        for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        log.seek(0)
        text = log.read()
        log.close()
        assert p.returncode == 0, text
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["w2", "w4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, _spawn(tmp_path_factory.mktemp(f"obs_w{world}"), world)


@pytest.fixture(scope="module")
def jax_ref():
    import jax.numpy as jnp

    from spearmint_tpu.core.likelihood import GPHypers as JHypers

    x, y, mask = _problem()
    h = JHypers(mean=jnp.float32(HYP["mean"]), amp2=jnp.float32(HYP["amp2"]),
                noise=jnp.float32(HYP["noise"]),
                ls=jnp.array(HYP["ls"], jnp.float32))
    return jnp.array(x), jnp.array(y), jnp.array(mask), h


@pytest.fixture(scope="module")
def jax_obs(ranks, jax_ref):
    """The JAX obs functions on a W-device obs mesh, as
    tests/test_obs_shard.py runs them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from spearmint_tpu.engine import obs_shard

    mesh = obs_shard.make_obs_mesh(n_devices=ranks[0])
    x, y, mask, h = jax_ref
    resid = jnp.where(mask, y - h.mean, 0.0)

    def dist(x, mask, r):
        a = obs_shard.cov_colblock(x, mask, h.amp2, h.noise, h.ls)
        l = obs_shard.cholesky_colblock(a)
        z = obs_shard.solve_colblock(l, r)
        return a, l, z, obs_shard._backsolve(l, z)

    a, l, z, w = jax.jit(jax.shard_map(
        dist, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(None, obs_shard.OBS_AXIS), P(None, obs_shard.OBS_AXIS),
                   P(), P()), check_vma=False))(x, mask, resid)
    lp = obs_shard.sharded_logprob(mesh)(x, y, mask, h.mean, h.amp2, h.noise,
                                         h.ls)
    mu, var = obs_shard.sharded_posterior(mesh)(
        x, y, mask, jnp.array(_cands(11, 17)), h.mean, h.amp2, h.noise, h.ls)
    return {k: np.asarray(v) for k, v in dict(
        a=a, l=l, z=z, w=w, lp=lp, mu=mu, var=var).items()}


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded steps on the ranks' inputs and seeds."""
    from spearmint_tpu_torch.engine.per_sec import suggest_step_per_sec
    from spearmint_tpu_torch.engine.suggest import SuggestConfig, suggest_step
    from spearmint_tpu_torch.mcmc.chains import MCMCConfig, sample_hypers

    torch.set_num_threads(1)
    x, y, mask = _problem()
    cfg = SuggestConfig(mcmc_iters=ITERS, optimize=False)
    no_pend = (np.zeros((4, 3), np.float32), np.zeros(4, bool))
    out = {"sweep": sample_hypers(_gen(42), _chains(y, mask, 3, 1), _t(x),
                                  _t(y), _t(mask, torch.bool), MCMCConfig())}
    out["obs"] = suggest_step(_gen(7), _chains(y, mask, 3), x, y, mask,
                              *no_pend, _cands(5, 100), np.ones(100, bool),
                              cfg, device="cpu")
    hp = _chains(y, mask, 3)
    hp = hp._replace(amp2=hp.amp2.index_fill(0, torch.tensor([0]),
                                             float("inf")))
    out["nan"] = suggest_step(_gen(11), hp, x, y, mask, *no_pend,
                              _cands(9, 64), np.ones(64, bool), cfg,
                              device="cpu")
    ld = _log_durs(mask)
    out["ps"] = suggest_step_per_sec(
        _gen(13), _chains(y, mask, 3), _chains(ld, mask, 3), x, y, ld, mask,
        *no_pend, _cands(6, 64), np.ones(64, bool), cfg, device="cpu")
    return out


def _gather_cols(world_ranks, key):
    return np.concatenate([r[key] for r in world_ranks], axis=-1)


def test_ranks_agree_bit_for_bit(ranks):
    world, rs = ranks
    assert int(rs[0]["world"]) == world
    assert [bool(r["coordinator"]) for r in rs] == [True] + [False] * (
        world - 1)
    for key in rs[0]:
        # each rank's own slab; the coordinator's flag; the event log as
        # the rank read it, which the coordinator alone writes
        if key in ("coordinator", "a_col", "l_col") or key.endswith(".modes"):
            continue
        for r in rs[1:]:
            np.testing.assert_array_equal(r[key], rs[0][key], err_msg=key)


def test_cov_and_cholesky_match(ranks, jax_obs):
    _, rs = ranks
    want = jax_obs
    np.testing.assert_allclose(_gather_cols(rs, "a_col"), want["a"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_gather_cols(rs, "l_col"), want["l"],
                               rtol=2e-4, atol=2e-5)


def test_solves_match(ranks, jax_obs):
    rs, want = ranks[1], jax_obs
    np.testing.assert_allclose(rs[0]["z"], want["z"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(rs[0]["w"], want["w"], rtol=2e-3, atol=2e-4)


def test_logprob_matches(ranks, jax_obs):
    want = float(jax_obs["lp"])
    got = float(ranks[1][0]["lp"][0])
    assert abs(got - want) / max(1.0, abs(want)) < 2e-4


def test_posterior_matches(ranks, jax_obs):
    rs, want = ranks[1], jax_obs
    np.testing.assert_allclose(rs[0]["mu"], want["mu"], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(rs[0]["var"], want["var"], rtol=2e-3,
                               atol=2e-4)


def test_sharded_slice_sweep_matches_single_device(ranks, unsharded):
    """Same generator → the same accept/reject path as the unsharded
    sweep, up to float32 reduction-order noise."""
    _, rs = ranks
    want = unsharded["sweep"]
    for name in ("mean", "amp2", "noise", "ls"):
        np.testing.assert_allclose(rs[0][f"sweep.{name}"],
                                   getattr(want, name).numpy(), rtol=1e-3,
                                   err_msg=name)


def test_sharded_suggest_obs_matches_single_device(ranks, unsharded):
    _, rs = ranks
    r, want = rs[0], unsharded["obs"]
    assert int(r["obs.best_cand"]) == int(want.best_cand)
    assert int(r["obs.n_ok"]) == int(want.n_ok) == CHAINS * ITERS
    np.testing.assert_allclose(r["obs.ei"], want.ei.numpy(), rtol=2e-3,
                               atol=1e-6)
    for name in ("mean", "amp2", "noise", "ls"):
        np.testing.assert_allclose(r[f"obs.hypers.{name}"],
                                   getattr(want.hypers, name).numpy(),
                                   rtol=1e-3, err_msg=name)


def test_nan_sample_excluded_from_obs_sharded_ei(ranks, unsharded):
    """A chain pinned at amp2 = inf: every marginal −inf, so it stays put
    and its samples' factorizations are NaN; both engines exclude them."""
    _, rs = ranks
    r, want = rs[0], unsharded["nan"]
    assert int(r["nan.n_ok"]) == (CHAINS - 1) * ITERS
    assert int(want.n_ok) == (CHAINS - 1) * ITERS
    ei = r["nan.ei"]
    assert np.isfinite(ei).all() and ei.max() > 0.0
    np.testing.assert_allclose(ei, want.ei.numpy(), rtol=2e-3, atol=1e-6)
    assert int(r["nan.best_cand"]) == int(want.best_cand)


def test_sharded_suggest_per_sec_matches_single_device(ranks, unsharded):
    _, rs = ranks
    r, want = rs[0], unsharded["ps"]
    assert int(r["ps.best_cand"]) == int(want.best_cand)
    np.testing.assert_allclose(r["ps.ei_per_s"], want.ei_per_s.numpy(),
                               rtol=2e-3, atol=1e-7)
    for fam in ("hypers", "time_hypers"):
        for name in ("mean", "amp2", "noise", "ls"):
            np.testing.assert_allclose(
                r[f"ps.{fam}.{name}"],
                getattr(getattr(want, fam), name).numpy(), rtol=1e-3,
                err_msg=f"{fam}.{name}")
    assert int(r["ps.n_ok"]) == CHAINS * ITERS


@pytest.mark.parametrize("name", ["GPEIOptChooser", "GPEIperSecChooser"])
def test_chooser_uses_obs_shard_path(ranks, name):
    """With obs_shard_min lowered and several ranks the GP choosers route
    through the obs-sharded step; with a job pending, through the chains
    path.  Every rank returns the same suggestion, and the coordinator
    alone writes the events (one line a suggestion)."""
    _, rs = ranks
    assert list(rs[0][name + ".modes"]) == ["obs_shard", "chains"]
    picks = rs[0][name + ".picks"]
    assert 30 <= int(picks[0]) < 80   # the grid argmax: an index
    for r in rs[1:]:
        np.testing.assert_array_equal(r[name + ".picks"], picks)


def test_one_process_takes_the_chains_path(tmp_path, monkeypatch):
    """Without a process group the chooser runs the chains path whatever
    the pad, and however many GPUs the process would see: the rank count
    comes from the group."""
    from spearmint_tpu_torch.choosers import get_chooser
    from spearmint_tpu_torch.engine import distributed

    torch.set_num_threads(1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert distributed.world_size() == 1 and distributed.is_coordinator()
    grid, values, durations, cands, complete = _chooser_history()
    ch = get_chooser("GPEIOptChooser", str(tmp_path),
                     CHOOSER_ARGS + ",burnin=2")
    ch.next(grid, values, durations, cands, [], complete)
    ev = [e for e in ch.events.read() if e["kind"] == "suggest"]
    assert [e["mode"] for e in ev] == ["chains"]


def test_obs_gate_matches_jax():
    from spearmint_tpu.engine.obs_shard import use_obs_gate as jax_gate
    from spearmint_tpu_torch.engine.obs_shard import use_obs_gate

    for args in [(8192, 2, 8192, 0), (8192, 2, 4096, 0), (8192, 1, 8192, 0),
                 (8192, 3, 8192, 0), (8192, 2, 8192, 1), (0, 2, 8192, 0),
                 (32, 4, 32, 0)]:
        assert use_obs_gate(*args) == jax_gate(*args), args


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
              sys.argv[5])
