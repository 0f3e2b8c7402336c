"""The port's spans and counters on the CPU: the sampler's and L-BFGS's
loop ranges in a ``profile_dir`` trace against the counters the call
moved, each stage range opening and closing on work of its own, the
``suggest`` event's record of a call, L-BFGS's useful iterations against
a plain loop, ``stage_times`` without a synchronize a stage, and answers
that do not depend on whether the call was traced.
"""

import os

import numpy as np
import pytest
import torch

from spearmint_tpu_torch.acquire.optimize import minimize_lbfgs_b
from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.utils import trace
from spearmint_tpu_torch.utils.events import EventLog

torch.set_num_threads(1)

ITERS = 4
ARGS = f"chains=2,mcmc_iters=2,burnin=2,grid_subset=2,lbfgs_iters={ITERS}"
STAGES = {
    "GPEIOptChooser": {"mcmc", "caches", "ei", "lbfgs"},
    "GPEIperSecChooser": {"mcmc", "caches", "ei", "lbfgs"},
    "GPConstrainedEIChooser": {"mcmc", "constraint", "caches", "acq",
                               "lbfgs"},
}
FLAGSHIPS = ("GPEIOptChooser", "GPEIperSecChooser")
# The benchmark's trace reader labels an idle gap with the innermost host
# range that holds it, looking back at most this many ranges
# (portbench/tracing._innermost): a gap directly under ``stage:mcmc`` late
# in the stage keeps its label only while fewer ranges start inside the
# stage before it.
READER_LOOK_BACK = 512
# The wrapper ranges one marginal evaluation opens on the card and not on
# the CPU, where no kernel runs: B1's and the covariance assembly's.
CARD_WRAPPERS = ("shifted_logdet_q", "unit_cov")
# The largest profiled suggestion of the benchmark's per_sec cell (both
# families, H100; PERF.md §3): B1 launches, slice:eval and slice:read
# ranges inside stage:mcmc.
CELL_B1, CELL_EVALS, CELL_READS = 113, 111, 117


def _problem(seed=0, n_grid=24, n_done=8, violations=False):
    rng = np.random.RandomState(seed)
    grid = rng.rand(n_grid, 2)
    values = np.full(n_grid, np.nan)
    values[:n_done] = rng.randn(n_done)
    if violations:
        values[:n_done:4] = np.nan
    return (grid, values, np.exp(grid[:, 0]), np.arange(n_done, n_grid),
            np.array([], int), np.arange(n_done))


def _suggests(expt):
    return [e for e in EventLog(str(expt)).read() if e["kind"] == "suggest"]


def _traced_call(tmp_path, name):
    """One profiled ``next`` (the chooser's second: the first burns in);
    returns the trace's events and the call's ``suggest`` event."""
    prof = tmp_path / "prof"
    ch = get_chooser(name, str(tmp_path),
                     f"profile_dir={prof},{ARGS},device=cpu")
    ch.next(*_problem())
    for f in os.listdir(prof):
        os.remove(prof / f)
    ch.next(*_problem())
    (path,) = os.listdir(prof)
    return trace.load(str(prof / path)), _suggests(tmp_path)[-1]


def _annotations(events):
    return [e for e in events if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("name", FLAGSHIPS)
def test_trace_holds_a_range_a_loop_step(tmp_path, name):
    """L-BFGS: one ladder a iteration, one value and gradient a iteration
    and one before the first; the sampler: one ``slice:eval`` range an
    evaluation and one ``slice:read`` range a read, as counted."""
    events, ev = _traced_call(tmp_path, name)
    got = {}
    for e in _annotations(events):
        got[e["name"]] = got.get(e["name"], 0) + 1
    assert got["lbfgs:ladder"] == ITERS
    assert got["lbfgs:grad"] == ITERS + 1
    assert got["lbfgs:update"] == ITERS + 1
    assert got["slice:eval"] == ev["counts"]["slice:evals"] > 0
    assert got["slice:read"] == ev["counts"]["slice:reads"] > 0
    assert ev["counts"]["lbfgs:iters"] == ITERS
    assert 1 <= ev["counts"]["lbfgs:useful_iters"] <= ITERS
    assert ev["counts"]["ei:chunks"] == 1


@pytest.mark.parametrize("name", FLAGSHIPS)
def test_each_stage_range_opens_and_closes_on_its_own_work(tmp_path, name):
    """A kernel is drawn under the innermost range open when it launched,
    and a stage's device span runs from its first to its last kernel of
    its own: so the first and the last operation inside each ``stage:*``
    range have that stage, not a loop range nested in it, as their
    innermost range."""
    events, _ = _traced_call(tmp_path, name)
    ranges = _annotations(events)
    ops = [e for e in events if e.get("cat") == "cpu_op"]

    def within(e, r):
        return (e["tid"] == r["tid"] and r["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= r["ts"] + r["dur"])

    stages = [r for r in ranges if r["name"].startswith(trace.STAGE_PREFIX)]
    assert {r["name"][len(trace.STAGE_PREFIX):] for r in stages} == (
        STAGES[name])
    for st in stages:
        mine = sorted((o for o in ops if within(o, st)),
                      key=lambda o: o["ts"])
        assert mine, st["name"]
        for op in (mine[0], mine[-1]):
            inner = max((r for r in ranges if within(op, r)),
                        key=lambda r: r["ts"])
            assert inner["name"] == st["name"], (st["name"], op["name"],
                                                 inner["name"])


@pytest.mark.parametrize("name", FLAGSHIPS)
def test_mcmc_stage_ranges_stay_inside_the_trace_readers_look_back(
        tmp_path, name):
    """The ranges that start inside ``stage:mcmc`` are the sampler's own,
    one an evaluation and one a read as counted; on the card each marginal
    evaluation adds B1's and the assembly's wrapper ranges.  So the
    per_sec cell's largest profiled suggestion opens 454 ranges in the
    stage, and it would take a tenth more evaluations to reach the
    reader's look-back."""
    events, ev = _traced_call(tmp_path, name)
    ranges = _annotations(events)
    (st,) = [r for r in ranges if r["name"] == trace.STAGE_PREFIX + "mcmc"]
    inside = {}
    for r in ranges:
        if r is not st and st["ts"] <= r["ts"] <= st["ts"] + st["dur"]:
            inside[r["name"]] = inside.get(r["name"], 0) + 1
    assert inside == {"slice:eval": ev["counts"]["slice:evals"],
                      "slice:read": ev["counts"]["slice:reads"]}
    assert set(CARD_WRAPPERS) <= set(trace.KERNEL_RANGES)
    on_card = CELL_EVALS + CELL_READS + len(CARD_WRAPPERS) * CELL_B1
    assert on_card == 454
    per_b1 = on_card / CELL_B1
    assert 1.1 * CELL_B1 * per_b1 < READER_LOOK_BACK


@pytest.mark.parametrize("name", sorted(STAGES))
def test_suggest_event_records_the_call(tmp_path, name):
    """Every call's event carries its stage seconds (the step's stages,
    each ≥ 0, together within the latency), the counters it moved, the
    host's prepare and save seconds, and its key state."""
    ch = get_chooser(name, str(tmp_path), f"{ARGS},device=cpu")
    args = _problem(violations=name == "GPConstrainedEIChooser")
    for call in range(2):
        ch.next(*args)
        ev = _suggests(tmp_path)[-1]
        assert set(ev["stage_s"]) == STAGES[name]
        assert all(v >= 0 for v in ev["stage_s"].values())
        # latency_s is rounded to 4 places
        assert sum(ev["stage_s"].values()) <= ev["latency_s"] + 5e-5
        assert ev["counts"]["slice:evals"] > 0
        assert ev["counts"]["lbfgs:iters"] == ITERS
        assert all(isinstance(v, int) and v > 0
                   for v in ev["counts"].values())
        assert set(ev["host_s"]) == {"prepare", "save"}
        assert all(v >= 0 for v in ev["host_s"].values())
        assert ev["call"] == call
        assert ev["latency_s"] > 0 and ev["n_ok"] > 0


def test_grid_only_chooser_counts_no_lbfgs(tmp_path):
    """``GPEIChooser`` runs no refinement: no L-BFGS counter moves."""
    ch = get_chooser("GPEIChooser", str(tmp_path), f"{ARGS},device=cpu")
    ch.next(*_problem())
    ev = _suggests(tmp_path)[-1]
    assert not any(k.startswith("lbfgs:") for k in ev["counts"])
    assert ev["counts"]["slice:evals"] > 0


def test_counters_are_host_integers_apart_from_kernel_launches():
    before = trace.counters()
    trace.count("test:things", 3)
    trace.count("test:things")
    after = trace.counters()
    assert after["test:things"] - before.get("test:things", 0) == 4
    after["test:things"] = -1                     # a snapshot, not a view
    assert trace.counters()["test:things"] > 0
    assert set(trace.kernel_launches()) == set(trace.KERNEL_RANGES)


# ------------------------------------------------ L-BFGS's useful iterations
def _anisotropic(x):
    return ((x - torch.tensor([0.3, 0.7])) ** 2
            * torch.tensor([1.0, 30.0])).sum(-1)


def _pinned(x):
    # x0 runs to its upper bound and stays pinned there; x1's slope
    # (1e-5) keeps the projected gradient over tol, but a step along it
    # moves the value by less than float32 resolves at 99, so the Armijo
    # test's <= accepts a step that does not improve: the lane stalls
    # with ls_ok true and is never marked done
    return 100.0 - x[:, 0] + 1e-5 * x[:, 1]


def _plain_useful(fun, x0, iters):
    """The index + 1 of the last iteration that improved a lane not yet
    done, from runs of 0, 1, ..., ``iters`` iterations (the loop is
    deterministic, so a run of k iterations is the first k of a longer
    one)."""
    box = (torch.zeros(2), torch.ones(2))
    prev = minimize_lbfgs_b(fun, x0, *box, iters=0)
    last = 0
    for k in range(1, iters + 1):
        res = minimize_lbfgs_b(fun, x0, *box, iters=k)
        if bool(((res.fun < prev.fun) & ~prev.converged).any()):
            last = k
        prev = res
    return last, prev


@pytest.mark.parametrize("fun,stalls", [(_anisotropic, False),
                                        (_pinned, True)],
                         ids=["quadratic", "pinned"])
def test_useful_iters_equals_a_plain_loop(fun, stalls):
    iters = 20
    x0 = torch.tensor([[0.9, 0.1], [0.5, 0.5], [0.1, 0.95]])
    want, plain = _plain_useful(fun, x0, iters)
    res = minimize_lbfgs_b(fun, x0, torch.zeros(2), torch.ones(2),
                           iters=iters)
    assert int(res.useful_iters) == want
    assert 1 <= want < iters                  # the lanes stop improving
    assert torch.equal(res.x, plain.x) and torch.equal(res.fun, plain.fun)
    if stalls:
        assert not res.converged.any()        # ... but are never done
        assert torch.all(res.x[:, 0] == 1.0)
    else:
        assert res.converged.all()


def test_useful_iters_of_no_iteration_is_zero():
    res = minimize_lbfgs_b(_anisotropic, torch.tensor([[0.9, 0.1]]),
                           torch.zeros(2), torch.ones(2), iters=0)
    assert int(res.useful_iters) == 0


# ---------------------------------------------------------- stage_times
def _step_inputs(n=8, c=16, seed=0):
    from spearmint_tpu_torch.engine.suggest import init_chain_states

    rng = np.random.RandomState(seed)
    x = np.zeros((16, 2), np.float32)
    x[:n] = rng.rand(n, 2)
    y = np.zeros(16, np.float32)
    y[:n] = rng.randn(n)
    mask = np.arange(16) < n
    h = init_chain_states(torch.tensor(y), torch.tensor(mask), 2, 2)
    return x, y, mask, rng.rand(c, 2).astype(np.float32), h


@pytest.mark.parametrize("step", ["suggest", "per_sec", "constrained"])
def test_stage_times_keeps_its_keys(step):
    from spearmint_tpu_torch.engine.suggest import SuggestConfig

    x, y, mask, cand, h = _step_inputs()
    cfg = SuggestConfig(mcmc_iters=1, grid_subset=2, lbfgs_iters=2)
    gen = torch.Generator().manual_seed(0)
    pend, pmask = np.zeros((4, 2), np.float32), np.zeros(4, bool)
    cmask = np.ones(len(cand), bool)
    st = {}
    if step == "suggest":
        from spearmint_tpu_torch.engine.suggest import suggest_step

        res = suggest_step(gen, h, x, y, mask, pend, pmask, cand, cmask,
                           cfg, device="cpu", stage_times=st)
        keys = {"mcmc", "caches", "ei", "lbfgs"}
    elif step == "per_sec":
        from spearmint_tpu_torch.engine.per_sec import suggest_step_per_sec

        res = suggest_step_per_sec(gen, h, h, x, y, np.abs(y), mask, pend,
                                   pmask, cand, cmask, cfg, device="cpu",
                                   stage_times=st)
        keys = {"mcmc", "caches", "ei", "lbfgs"}
    else:
        from spearmint_tpu_torch.engine.constrained import (
            init_constraint_states, suggest_step_constrained,
        )

        cons = init_constraint_states(2, 16, 2, device="cpu")
        valid = mask.copy()
        valid[0] = False
        res = suggest_step_constrained(gen, h, cons, x, y, valid, mask,
                                       cand, cmask, cfg, device="cpu",
                                       stage_times=st)
        keys = {"mcmc", "constraint", "caches", "acq", "lbfgs"}
    assert set(st) == keys and all(v >= 0 for v in st.values())
    assert 1 <= int(res.lbfgs_useful) <= 2


def test_stage_clock_without_stage_times_times_nothing():
    clock = trace.StageClock(None, "cpu")
    with clock.stage("mcmc"):
        pass
    clock.close()
    assert clock.marks == []
    got = {"mcmc": 1.0}
    clock = trace.StageClock(got, "cpu")
    for _ in range(2):
        with clock.stage("mcmc"):
            pass
    clock.close()
    assert got["mcmc"] >= 1.0 and clock.marks == []


# ------------------------------------------------------ tracing on and off
@pytest.mark.parametrize("name", FLAGSHIPS)
def test_answers_and_chain_states_do_not_depend_on_tracing(tmp_path, name):
    out = {}
    for traced in (False, True):
        expt = tmp_path / str(traced)
        os.makedirs(expt)
        extra = f"profile_dir={expt / 'prof'}," if traced else ""
        ch = get_chooser(name, str(expt), f"{extra}{ARGS},device=cpu")
        answers = [ch.next(*_problem(seed=3)) for _ in range(2)]
        states = [a.numpy() for a in ch._hypers]
        if name == "GPEIperSecChooser":
            states += [a.numpy() for a in ch._time_hypers]
        out[traced] = answers, states
    (a0, s0), (a1, s1) = out[False], out[True]
    for x, y in zip(a0, a1):
        if isinstance(x, tuple):
            assert x[0] == y[0] and np.array_equal(x[1], y[1])
        else:
            assert x == y
    assert all(np.array_equal(x, y) for x, y in zip(s0, s1))
