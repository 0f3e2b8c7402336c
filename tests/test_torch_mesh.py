"""The chains × candidates mesh and the process-group bootstrap: the
port's ``engine/mesh`` and ``engine/distributed`` on gloo ranks, held to
the port's unsharded ``suggest_step`` on the same seed.

As ``tests/test_sharding.py`` holds the JAX package's GSPMD step to its
unsharded one (GSPMD must not change the math), every mesh here must give
the unsharded step's EI, argmax, refined point and chain states at that
test's tolerances, pending branch included; and, as
``tests/test_distributed.py`` asks of two jax processes, every rank's
suggestion must be the same bit for bit.  The ranks are processes started
from this file (its ``__main__``), one spawn per world size (2 and 4),
each on the CPU with one thread, joined through a FileStore.  Without a
process group the sampler must draw exactly what it drew before the mesh
existed (a pinned output).

The whole step cannot be held to the JAX package's sharded step on the
same seed: the port draws from a ``torch.Generator`` and JAX from a
threefry key, so the two samplers walk different chains.  What ties
``suggest_step`` itself to JAX is
``tests/test_torch_suggest.py::test_ei_landscape_matches_jax_and_golden``
(and, piece by piece, the sampler, the caches and EI in
``tests/test_torch_mcmc.py`` and ``tests/test_torch_acquire.py``).  The
part of the mesh's step that draws nothing is held to JAX here: given the
samples a mesh drew, its EI average over the chain and candidate shards
must equal JAX's, jitted over a JAX mesh of the same shape.
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
MESHES = {2: [(2, 1), (1, 2)], 4: [(4, 1), (2, 2), (1, 4)]}
PENDING_MESH = {2: (2, 1), 4: (2, 2)}
CHAINS = 8


def _problem(pending=False):
    """tests/test_sharding.py's: 20 points padded to 32, D=2, 64
    candidates, 8 chains; with ``pending``, its pending branch's points."""
    from spearmint_tpu_torch.engine.suggest import init_chain_states

    rng = np.random.RandomState(0)
    n, pad, d, cands = 20, 32, 2, 64
    x = rng.rand(n, d).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + 0.1 * rng.randn(n)).astype(np.float32)
    xp = np.zeros((pad, d), np.float32)
    xp[:n] = x
    yp = np.zeros(pad, np.float32)
    yp[:n] = y
    mask = np.arange(pad) < n
    cand = rng.rand(cands, d).astype(np.float32)
    hypers = init_chain_states(torch.tensor(yp), torch.tensor(mask), d,
                               CHAINS)
    pend = np.zeros((4, d), np.float32)
    pend_mask = np.zeros(4, bool)
    if pending:
        pend = np.random.RandomState(1).rand(4, 2).astype(np.float32)
        pend_mask = np.array([True, True, False, False])
    return (hypers, xp, yp, mask, pend, pend_mask, cand,
            np.ones(cands, bool))


def _config(pending=False):
    from spearmint_tpu_torch.engine.suggest import SuggestConfig

    return SuggestConfig(mcmc_iters=2, grid_subset=4, lbfgs_iters=8,
                         has_pending=pending)


def _gen():
    g = torch.Generator()
    g.manual_seed(0)
    return g


def _arrays(res, prefix):
    out = {}
    for f in ("ei", "best_cand", "x_opt", "ei_opt", "n_ok"):
        out[f"{prefix}.{f}"] = getattr(res, f).detach().numpy()
    for fam in ("hypers", "samples"):
        for k, a in getattr(res, fam)._asdict().items():
            out[f"{prefix}.{fam}.{k}"] = a.numpy()
    return out


# --------------------------------------------------------------- the ranks
def rank_main(rank, world, store, out_path):
    from spearmint_tpu_torch.engine import distributed, mesh

    torch.set_num_threads(1)
    distributed.initialize(f"file://{store}", world, rank, backend="gloo",
                           timeout=datetime.timedelta(seconds=120))
    out = {"world": np.array(distributed.world_size()),
           "coordinator": np.array(distributed.is_coordinator()),
           "default_shape": np.array(mesh.make_mesh(device="cpu").shape)}
    for shape in MESHES[world]:
        m = mesh.make_mesh(*shape, device="cpu")
        res = mesh.sharded_suggest(m, _config())(_gen(), *_problem())
        out.update(_arrays(res, f"{shape[0]}x{shape[1]}"))
    m = mesh.make_mesh(*PENDING_MESH[world], device="cpu")
    res = mesh.sharded_suggest(m, _config(True))(_gen(), *_problem(True))
    out.update(_arrays(res, "pending"))
    np.savez(out_path, **out)


def diverging_rank_main(rank, world, store, out_path):
    """Rank 0 makes a collective that rank 1 never makes: it must fail at
    the group's timeout, not hang."""
    import torch.distributed as dist

    from spearmint_tpu_torch.engine import distributed

    distributed.initialize(f"file://{store}", world, rank, backend="gloo",
                           timeout=datetime.timedelta(seconds=3))
    if rank == 0:
        t0 = time.monotonic()
        try:
            dist.all_reduce(torch.ones(4))
            raised = ""
        except RuntimeError as e:
            raised = str(e)[:200]
        np.savez(out_path, raised=np.array(raised),
                 seconds=np.array(time.monotonic() - t0))
    else:
        time.sleep(10)
        np.savez(out_path, raised=np.array(""), seconds=np.array(0.0))


# ------------------------------------------------------- the test process
def _spawn(tmp_path, world, *extra):
    """Start the ranks, wait for all of them within RANK_TIMEOUT_S (each
    one's output to a log file, so none can block on a full pipe), stop
    every one still running, and return each rank's results."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(store), str(tmp_path / f"rank{r}.npz"), *extra],
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


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """world → every rank's results, one spawn per world size."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _spawn(tmp_path_factory.mktemp(f"mesh_w{world}"),
                                  world)
        return cache[world]

    return get


@pytest.fixture(scope="module")
def unsharded():
    from spearmint_tpu_torch.engine.suggest import suggest_step

    torch.set_num_threads(1)
    return {p: suggest_step(_gen(), *_problem(p), _config(p), device="cpu")
            for p in (False, True)}


def _hold(got: dict, prefix, want):
    """tests/test_sharding.py's tolerances."""
    np.testing.assert_allclose(got[prefix + ".ei"], want.ei.numpy(),
                               rtol=2e-3, atol=1e-5)
    assert int(got[prefix + ".best_cand"]) == int(want.best_cand)
    np.testing.assert_allclose(got[prefix + ".x_opt"],
                               want.x_opt.detach().numpy(), rtol=1e-2,
                               atol=1e-3)
    for k, a in want.hypers._asdict().items():
        np.testing.assert_allclose(got[f"{prefix}.hypers.{k}"], a.numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=k)
    assert int(got[prefix + ".n_ok"]) == int(want.n_ok)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (4, 1), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_matches_unsharded(spawned, unsharded, shape):
    ranks = spawned(shape[0] * shape[1])
    _hold(ranks[0], f"{shape[0]}x{shape[1]}", unsharded[False])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_pending_branch(spawned, unsharded, world):
    """The fantasy branch on a mesh: the draws are made for every sample
    and each rank keeps its own, so the unsharded step's numbers come
    back."""
    got = spawned(world)[0]
    assert np.isfinite(got["pending.ei"]).all()
    _hold(got, "pending", unsharded[True])


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_bootstrap(spawned, world):
    ranks = spawned(world)
    assert [int(r["world"]) for r in ranks] == [world] * world
    assert [bool(r["coordinator"]) for r in ranks] == [True] + [False] * (
        world - 1)
    for r in ranks:   # default layout: every rank on the chains axis
        assert tuple(r["default_shape"]) == (world, 1)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_suggests_the_same_point(spawned, world):
    ranks = spawned(world)
    for key in ranks[0]:
        if key == "coordinator":
            continue
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)


def test_a_diverging_rank_fails_at_the_timeout(tmp_path):
    got = _spawn(tmp_path, 2, "diverge")[0]
    assert str(got["raised"]), "the lone collective returned"
    assert 2.0 < float(got["seconds"]) < 9.0


def test_without_a_group(tmp_path):
    """No process group: one rank, the coordinator; the mesh is 1×1 and
    its step is ``suggest_step`` bit for bit; a mesh larger than the world
    or a chain_chunk is refused."""
    from spearmint_tpu_torch.engine import distributed, mesh
    from spearmint_tpu_torch.engine.suggest import suggest_step

    torch.set_num_threads(1)
    assert distributed.world_size() == 1 and distributed.is_coordinator()
    m = mesh.make_mesh(device="cpu")
    assert m.shape == (1, 1) and m.chains_group is None
    got = mesh.sharded_suggest(m, _config())(_gen(), *_problem())
    want = suggest_step(_gen(), *_problem(), _config(), device="cpu")
    for key, a in _arrays(want, "w").items():
        np.testing.assert_array_equal(_arrays(got, "w")[key], a,
                                      err_msg=key)
    with pytest.raises(ValueError, match="ranks"):
        mesh.make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="chain_chunk"):
        mesh.sharded_suggest(m, _config()._replace(chain_chunk=4))


def _jax_ei_average(got: dict, prefix: str, shape):
    """JAX's NaN-robust EI average over the samples a mesh drew (read from
    its results), jitted with the samples over ``chains`` and the
    candidates over ``cand`` of a JAX mesh of ``shape``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spearmint_tpu.acquire import ei as jei
    from spearmint_tpu.core.likelihood import GPHypers
    from spearmint_tpu.engine import mesh as jmesh
    from spearmint_tpu.engine.suggest import SuggestConfig, nan_robust_mean

    _, xp, yp, mask, _, _, cand, _ = _problem()
    kernel = SuggestConfig().kernel

    def average(flat, x, y, m, c):
        caches = jax.vmap(lambda h: jei.make_cache(
            x, y, m, h, kernel, with_inverse=True))(flat)
        eis = jax.vmap(lambda cc: jei.ei_from_cache_chunked(
            cc, x, m, c, kernel))(caches)
        ok = jnp.all(jnp.isfinite(caches.alpha.reshape(eis.shape[0], -1)),
                     axis=1)
        return nan_robust_mean(eis, ok)[0]

    mesh = jmesh.make_mesh(*shape, devices=jax.devices()[:shape[0]
                                                      * shape[1]])
    rep = NamedSharding(mesh, P())
    by_chain = NamedSharding(mesh, P(jmesh.CHAINS_AXIS))
    shardings = (GPHypers(by_chain, by_chain, by_chain,
                          NamedSharding(mesh, P(jmesh.CHAINS_AXIS, None))),
                 rep, rep, rep, NamedSharding(mesh, P(jmesh.CAND_AXIS, None)))
    flat = GPHypers(*(jnp.asarray(got[f"{prefix}.samples.{k}"])
                      for k in GPHypers._fields))
    return np.asarray(jax.jit(average, in_shardings=shardings)(
        flat, jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask),
        jnp.asarray(cand)))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (4, 1), (2, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fixed_sample_ei_average_matches_jax(spawned, shape):
    """The mesh's EI average of the samples it drew, against JAX's sharded
    average of the same samples, at tests/test_sharding.py's tolerance."""
    prefix = f"{shape[0]}x{shape[1]}"
    got = spawned(shape[0] * shape[1])[0]
    np.testing.assert_allclose(got[prefix + ".ei"],
                               _jax_ei_average(got, prefix, shape),
                               rtol=2e-3, atol=1e-5)


def test_suggest_shardings_match_jax():
    """The same inputs split over the same axes as the JAX step's."""
    import jax

    from spearmint_tpu.engine import mesh as jax_mesh
    from spearmint_tpu_torch.engine import mesh

    specs = jax_mesh.suggest_shardings(jax_mesh.make_mesh(8, 1))
    want = tuple(
        (jax.tree.leaves(sh)[0] if isinstance(sh, tuple) else sh).spec
        for sh in specs)
    want = tuple(spec[0] if len(spec) else None for spec in want)
    assert mesh.suggest_shardings(mesh.make_mesh(device="cpu")) == want


# Two carried sweeps of 4 chains (seed 0) on tests/test_sharding.py's
# problem, as the sampler gave them before it took a chain shard.
PINNED_SWEEPS = {
    "mean": ["0x1.4e99380000000p-4", "0x1.7282f80000000p-1",
             "0x1.1345340000000p-1", "0x1.c9b6760000000p-2"],
    "amp2": ["0x1.4a0fa40000000p-1", "0x1.4830000000000p+0",
             "0x1.e93bc40000000p-3", "0x1.fceed20000000p-4"],
    "noise": ["0x1.a32f0a0000000p-1", "0x1.8105520000000p-1",
              "0x1.6e318c0000000p-4", "0x1.9362880000000p-7"],
    "ls": ["0x1.6ad4a80000000p-2", "0x1.66168e0000000p-1",
           "0x1.9eaecc0000000p+0", "0x1.ec171c0000000p+0",
           "0x1.1335b40000000p-2", "0x1.85964a0000000p-1",
           "0x1.4dbf840000000p-3", "0x1.e91a600000000p-1"],
}


def test_sampler_without_a_group_is_unchanged():
    from spearmint_tpu_torch.engine.suggest import init_chain_states
    from spearmint_tpu_torch.mcmc.chains import MCMCConfig, sample_hypers

    torch.set_num_threads(1)
    _, xp, yp, mask = _problem()[:4]
    x, y, m = torch.tensor(xp), torch.tensor(yp), torch.tensor(mask)
    h = init_chain_states(y, m, 2, 4)
    gen = _gen()
    for _ in range(2):
        h = sample_hypers(gen, h, x, y, m, MCMCConfig())
    for k, want in PINNED_SWEEPS.items():
        got = [float(a).hex() for a in getattr(h, k).reshape(-1).tolist()]
        assert got == want, k


if __name__ == "__main__":
    main = diverging_rank_main if sys.argv[5:] == ["diverge"] else rank_main
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
