"""The port's whole slice on the CPU: suggest_step, the device rule and
the import rule (the choosers are in tests/test_torch_choosers.py).

The MCMC draws of the two packages differ (``torch.Generator`` against
``jax.random``), so the slice as a whole is held to the JAX package and
the float64 oracle through its EI landscape, as ``tests/test_parity.py``
holds the JAX package to the oracle.
"""

import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spearmint_tpu.golden import numpy_ref
from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.core.linalg import pad_bucket, pend_pad
from spearmint_tpu_torch.engine.suggest import (
    SuggestConfig, init_chain_states, nan_robust_mean, suggest_step,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def branin_unit(u):
    x, y = 15.0 * u[0] - 5.0, 15.0 * u[1]
    v = (y - (5.1 / (4 * math.pi ** 2)) * x ** 2 + (5 / math.pi) * x - 6) ** 2
    return v + 10 * (1 - 1 / (8 * math.pi)) * math.cos(x) + 10


def _padded(x, y, pend):
    n, p = len(x), len(pend)
    pad, ppad = pad_bucket(n), pend_pad(pad_bucket(n), p)
    xp = np.zeros((pad, 2), np.float32); xp[:n] = x
    yp = np.zeros(pad, np.float32); yp[:n] = y
    pp = np.zeros((ppad, 2), np.float32); pp[:p] = pend
    return xp, yp, np.arange(pad) < n, pp, np.arange(ppad) < p


@pytest.mark.parametrize("pending", [False, True], ids=["sync", "async"])
def test_suggest_step_improves_tiny_branin(pending):
    """Six suggestions on the CPU from six random points.  With pending,
    each suggestion is evaluated one step late, so every call fantasizes
    the previous one (kernel B2 on the augmented pad)."""
    rng = np.random.RandomState(0)
    cand = rng.rand(128, 2).astype(np.float32)
    x = [p for p in rng.rand(6, 2)]
    y = [branin_unit(p) for p in x]
    start_best = min(y)
    cfg = SuggestConfig(mcmc_iters=1, grid_subset=4, lbfgs_iters=10,
                        has_pending=pending, n_fantasies=4)
    gen = torch.Generator()
    gen.manual_seed(0)
    hypers = None
    queued = []
    for _ in range(6):
        xp, yp, mask, pp, pmask = _padded(np.array(x), np.array(y),
                                          np.array(queued).reshape(-1, 2))
        if hypers is None:
            hypers = init_chain_states(torch.tensor(yp), torch.tensor(mask),
                                       2, 4)
        res = suggest_step(gen, hypers, xp, yp, mask, pp, pmask, cand,
                           np.ones(128, bool), cfg, device="cpu")
        hypers = res.hypers
        assert int(res.n_ok) > 0 and bool(torch.isfinite(res.ei).all())
        if float(res.ei_opt) > float(res.best_cand_ei):
            nxt = res.x_opt.numpy().astype(np.float64)
        else:
            nxt = cand[int(res.best_cand)].astype(np.float64)
        assert np.all((nxt >= 0) & (nxt <= 1))
        queued.append(nxt)
        if pending and len(queued) < 2:
            continue
        done = queued.pop(0)
        x.append(done)
        y.append(branin_unit(done))
    assert min(y) < start_best, (start_best, y[6:])


def test_ei_landscape_matches_jax_and_golden():
    """Same data, candidates and chain count through the port, the JAX
    package and the float64 oracle: the port's sample-averaged EI
    correlates > 0.8 with both, and its argmax is worth ≥ half the
    oracle's best EI (tests/test_parity.py's criteria)."""
    rng = np.random.RandomState(5)
    x = rng.rand(30, 2)
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.05 * rng.randn(30)
    x, y = x.astype(np.float32), (y - y.mean()).astype(np.float32)
    cand = np.random.RandomState(11).rand(64, 2).astype(np.float32)
    xp, yp, mask, pp, pmask = _padded(x, y, np.zeros((0, 2)))
    cfg = SuggestConfig(mcmc_iters=8, optimize=False)

    gen = torch.Generator()
    gen.manual_seed(2)
    h = init_chain_states(torch.tensor(yp), torch.tensor(mask), 2, 6)
    for _ in range(3):
        res = suggest_step(gen, h, xp, yp, mask, pp, pmask, cand,
                           np.ones(64, bool), cfg, device="cpu")
        h = res.hypers
    ours = res.ei.numpy()

    from spearmint_tpu.engine import suggest as jsuggest

    xj, yj, mj = jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(mask)
    hj = jsuggest.init_chain_states(yj, mj, 2, 6)
    cfg_j = jsuggest.SuggestConfig(mcmc_iters=8, optimize=False)
    for i in range(3):
        rj = jsuggest.suggest_step(
            jax.random.PRNGKey(i), hj, xj, yj, mj, jnp.asarray(pp),
            jnp.asarray(pmask), jnp.asarray(cand), jnp.ones(64, bool), cfg_j)
        hj = rj.hypers
    theirs = np.asarray(rj.ei)

    _, gold, _ = numpy_ref.suggest(x.astype(float), y.astype(float),
                                   cand.astype(float), mcmc_iters=24,
                                   seed=1, burnin=40)
    assert np.corrcoef(ours, theirs)[0, 1] > 0.8
    assert np.corrcoef(ours, gold)[0, 1] > 0.8
    assert gold[int(res.best_cand)] >= 0.5 * gold.max()


def test_nan_robust_mean_excludes_failed_samples():
    s = torch.tensor([[1.0, 2.0], [float("nan"), 5.0], [3.0, 4.0]])
    ok = torch.tensor([True, True, False])
    mean, n_ok = nan_robust_mean(s, ok)
    assert int(n_ok) == 2
    np.testing.assert_allclose(mean.numpy(), [0.5, 3.5])
    mean0, n0 = nan_robust_mean(s, torch.zeros(3, dtype=torch.bool))
    assert int(n0) == 0 and float(mean0.abs().max()) == 0.0


# ------------------------------------------------- device and imports
def test_no_quiet_fallback_to_the_cpu(tmp_path, monkeypatch):
    """With no card, an entry point called without device="cpu" raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp, yp, mask, pp, pmask = _padded(np.random.rand(5, 2), np.arange(5.0),
                                      np.zeros((0, 2)))
    h = init_chain_states(torch.tensor(yp), torch.tensor(mask), 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        suggest_step(torch.Generator(), h, xp, yp, mask, pp, pmask,
                     np.random.rand(8, 2), np.ones(8, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_chooser("GPEIOptChooser", str(tmp_path))


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports the port (the constrained engine, ESS,
    the constrained chooser, band mode, EI per second, the store, the sync
    and async harnesses, the drivers, lite, the status page, the terminal
    view and the numpy-only choosers included), runs a tiny CPU suggestion,
    a tiny CPU constrained suggestion, a tiny CPU band-mode suggestion, a
    tiny CPU EI-per-second suggestion, the slice-count tool and a chooser
    ``next`` traced into ``profile_dir``, and has loaded no module of jax
    or of spearmint_tpu."""
    code = "\n".join([
        "import sys, numpy as np, torch",
        "import spearmint_tpu_torch",
        "from spearmint_tpu_torch.engine.suggest import (",
        "    SuggestConfig, init_chain_states, suggest_step)",
        "from spearmint_tpu_torch.engine.constrained import (",
        "    init_constraint_states, suggest_step_constrained)",
        "from spearmint_tpu_torch.choosers import get_chooser",
        "import spearmint_tpu_torch.choosers.GPConstrainedEIChooser",
        "import spearmint_tpu_torch.convert",
        "import spearmint_tpu_torch.mcmc.ess",
        "import spearmint_tpu_torch.ops.band",
        "import spearmint_tpu_torch.choosers.GPEIperSecChooser",
        "import spearmint_tpu_torch.store.codec",
        "import spearmint_tpu_torch.store.experiment",
        "import spearmint_tpu_torch.store.sobol",
        "import spearmint_tpu_torch.store.varmap",
        "import spearmint_tpu_torch.harness.loop",
        "import spearmint_tpu_torch.harness.runner",
        "import spearmint_tpu_torch.harness.sync",
        "import spearmint_tpu_torch.harness.main",
        "import spearmint_tpu_torch.harness.lite",
        "import spearmint_tpu_torch.harness.status",
        "import spearmint_tpu_torch.harness.watch",
        "import spearmint_tpu_torch.harness.drivers.fake",
        "import spearmint_tpu_torch.harness.drivers.local",
        "import spearmint_tpu_torch.harness.drivers.sge",
        "import spearmint_tpu_torch.choosers.RandomChooser",
        "import spearmint_tpu_torch.choosers.SequentialChooser",
        "import spearmint_tpu_torch.choosers.GridChooser",
        "import spearmint_tpu_torch.choosers.RandomForestEIChooser",
        "from spearmint_tpu_torch.harness.drivers import get_driver",
        "assert get_driver('fake').submit_job(None) == 1000",
        "from spearmint_tpu_torch.engine.per_sec import suggest_step_per_sec",
        "rng = np.random.RandomState(0)",
        "x = np.zeros((16, 2), np.float32); x[:6] = rng.rand(6, 2)",
        "y = np.zeros(16, np.float32); y[:6] = rng.randn(6)",
        "m = np.arange(16) < 6",
        "h = init_chain_states(torch.tensor(y), torch.tensor(m), 2, 2)",
        "g = torch.Generator(); g.manual_seed(0)",
        "r = suggest_step(g, h, x, y, m, np.zeros((4, 2), np.float32),",
        "                 np.zeros(4, bool), rng.rand(64, 2),",
        "                 np.ones(64, bool), SuggestConfig(mcmc_iters=1,",
        "                 lbfgs_iters=3, grid_subset=2), device='cpu')",
        "assert int(r.n_ok) > 0",
        "vm = m & (x[:, 0] < 0.7)",
        "c = init_constraint_states(2, 16, 2, device='cpu')",
        "r = suggest_step_constrained(g, h, c, x, np.where(vm, y, 0), vm,",
        "                             m, rng.rand(64, 2), np.ones(64, bool),",
        "                             SuggestConfig(mcmc_iters=1,",
        "                             lbfgs_iters=3, grid_subset=2),",
        "                             device='cpu')",
        "assert int(r.n_ok) > 0 and bool(torch.isfinite(r.acq).all())",
        "xb = np.zeros((128, 2), np.float32); xb[:40] = rng.rand(40, 2)",
        "yb = np.zeros(128, np.float32); yb[:40] = rng.randn(40)",
        "mb = np.arange(128) < 40",
        "hb = init_chain_states(torch.tensor(yb), torch.tensor(mb), 2, 2)",
        "r = suggest_step(g, hb, xb, yb, mb, np.zeros((4, 2), np.float32),",
        "                 np.zeros(4, bool), rng.rand(64, 2),",
        "                 np.ones(64, bool), SuggestConfig(mcmc_iters=1,",
        "                 lbfgs_iters=3, grid_subset=2, band_joint=True),",
        "                 device='cpu')",
        "assert int(r.n_ok) == 2 and bool(torch.isfinite(r.ei).all())",
        "r = suggest_step_per_sec(g, h, h, x, y, 2 * x[:, 0], m,",
        "                         np.zeros((4, 2), np.float32),",
        "                         np.zeros(4, bool), rng.rand(64, 2),",
        "                         np.ones(64, bool), SuggestConfig(",
        "                         mcmc_iters=1, lbfgs_iters=3,",
        "                         grid_subset=2), device='cpu')",
        "assert int(r.n_ok) > 0 and bool(torch.isfinite(r.ei_per_s).all())",
        "torch.set_num_threads(1)",
        "from spearmint_tpu_torch.tools import profile_slice_counts as psc",
        "assert psc.main(['2', '24', '--device', 'cpu'])['lockstep_mean'] > 0",
        "import os, tempfile",
        "d = tempfile.mkdtemp()",
        "ch = get_chooser('GPEIOptChooser', d, 'profile_dir=' + d + '/prof,'",
        "                 'chains=2,mcmc_iters=2,burnin=2,grid_subset=2,'",
        "                 'lbfgs_iters=3,device=cpu')",
        "grid = rng.rand(12, 2)",
        "vals = np.full(12, np.nan); vals[:5] = rng.randn(5)",
        "ch.next(grid, vals, np.zeros(12), np.arange(5, 12),",
        "        np.array([], int), np.arange(5))",
        "assert len(os.listdir(d + '/prof')) == 1",
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')",
        "       or k == 'spearmint_tpu' or k.startswith('spearmint_tpu.')]",
        "print('LOADED', bad)",
        "assert not bad, bad",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
