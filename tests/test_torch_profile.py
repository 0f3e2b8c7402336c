"""The port's instruments on the CPU: ``profile_dir`` through
``torch.profiler`` (one trace per ``next`` of every GP chooser, its stage
ranges, the kernel wrappers' ranges, the refusal of a trace that lost its
device events) and the per-sec chooser's decision against the JAX one.
The sampler's loop counters are held to the JAX sampler's in
``tests/test_torch_mcmc.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from spearmint_tpu_torch.choosers import get_chooser
from spearmint_tpu_torch.utils import trace

torch.set_num_threads(1)

ARGS = "chains=2,mcmc_iters=2,burnin=2,grid_subset=2,lbfgs_iters=3"
STAGES = {
    "GPEIOptChooser": {"mcmc", "caches", "ei", "lbfgs"},
    "GPEIChooser": {"mcmc", "caches", "ei", "lbfgs"},
    "GPEIperSecChooser": {"mcmc", "caches", "ei", "lbfgs"},
    "GPConstrainedEIChooser": {"mcmc", "constraint", "caches", "acq",
                               "lbfgs"},
}


def _problem(seed=0, n_grid=24, n_done=8, violations=False):
    rng = np.random.RandomState(seed)
    grid = rng.rand(n_grid, 2)
    values = np.full(n_grid, np.nan)
    values[:n_done] = rng.randn(n_done)
    if violations:
        values[:n_done:4] = np.nan      # the constraint's violations
    durations = np.exp(grid[:, 0])
    return (grid, values, durations, np.arange(n_done, n_grid),
            np.array([], int), np.arange(n_done))


@pytest.mark.parametrize("name", sorted(STAGES))
def test_every_gp_chooser_writes_one_trace_per_next(tmp_path, name):
    """Each ``next`` writes exactly one trace into profile_dir, which
    parses as JSON and holds one range per stage of the step."""
    prof = tmp_path / "prof"
    ch = get_chooser(name, str(tmp_path),
                     f"profile_dir={prof},{ARGS},device=cpu")
    args = _problem(violations=name == "GPConstrainedEIChooser")
    seen = set()
    for call in range(2):
        out = ch.next(*args)
        assert isinstance(out, (int, tuple))
        new = set(os.listdir(prof)) - seen
        assert len(new) == 1, (call, new)
        seen |= new
        (path,) = new
        assert path.endswith(".pt.trace.json")
        with open(prof / path) as f:
            json.load(f)
        got = trace.ranges(trace.load(str(prof / path)), trace.STAGE_PREFIX)
        assert {k[len(trace.STAGE_PREFIX):] for k in got} == STAGES[name]
        assert all(len(v) == 1 for v in got.values()), got


def test_per_sec_decision_jax_ignores_profile_dir_the_port_traces(tmp_path):
    """Reference defect (ROADMAP §C): the JAX per-sec chooser takes
    profile_dir through its base class and ignores it; its ``next`` never
    enters a trace.  The port's writes one trace per call."""
    from spearmint_tpu.choosers.GPEIperSecChooser import (
        GPEIperSecChooser as JaxChooser,
    )

    args = _problem(seed=1)
    jdir, jprof = tmp_path / "jax", tmp_path / "jax_prof"
    os.makedirs(jdir)
    jc = JaxChooser(str(jdir), profile_dir=str(jprof), chains=2,
                    mcmc_iters=2, burnin=2, grid_subset=2, lbfgs_iters=3)
    jc.next(*args)
    assert not jprof.exists() or not os.listdir(jprof)

    pdir, pprof = tmp_path / "port", tmp_path / "port_prof"
    os.makedirs(pdir)
    pc = get_chooser("GPEIperSecChooser", str(pdir),
                     f"profile_dir={pprof},{ARGS},device=cpu")
    pc.next(*args)
    pc.next(*args)
    assert len(os.listdir(pprof)) == 2


def test_empty_profile_dir_runs_no_profiler(tmp_path, monkeypatch):
    """profile_dir empty (the default): the step runs with no profiler
    object at all."""
    import torch.profiler

    def refuse(*a, **kw):
        raise AssertionError("a profiler was made")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    ch = get_chooser("GPEIOptChooser", str(tmp_path), f"{ARGS},device=cpu")
    assert ch.profile_dir == ""
    assert isinstance(ch.next(*_problem()), (int, tuple))
    ch = get_chooser("GPEIOptChooser", str(tmp_path),
                     f"profile_dir={tmp_path / 'p'},{ARGS},device=cpu")
    with pytest.raises(AssertionError, match="profiler was made"):
        ch.next(*_problem())


def test_kernel_wrappers_are_ranges_of_their_names(tmp_path):
    """Every kernel wrapper call is a range under the wrapper's name (on
    the CPU its plain version runs inside it, with no device event)."""
    from torch.profiler import ProfilerActivity, profile

    from spearmint_tpu_torch.ops import band, gp_kernels as gk

    rng = np.random.default_rng(0)
    f = rng.standard_normal((2, 16, 4)).astype(np.float32)
    m = torch.tensor(np.einsum("knd,kmd->knm", f, f) / 4)
    d = torch.full((2, 16), 0.5)
    r = torch.tensor(rng.standard_normal((2, 16)).astype(np.float32))
    kmat = m + torch.diag_embed(d)
    a = torch.eye(8).expand(2, 4, 8, 8).contiguous() * 2.0
    bb = torch.zeros(2, 4, 8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gk.shifted_logdet_q(m, d, r)
        gk.shifted_factor_logdet_q(m, d, r)
        _, _, lmat, _ = gk.factor_logdet_q(kmat, r)
        gk.logdet_q(kmat, r)
        gk.tri_inverse(lmat)
        band.cr_logdet_q(a, bb, torch.ones(2, 32))
    path = str(tmp_path / "wrappers.json")
    prof.export_chrome_trace(path)
    got = trace.ranges(trace.load(path), trace.KERNEL_RANGES)
    assert got == {name: [0] for name in trace.KERNEL_RANGES}


def _fake_trace(device_events):
    """Two B1 ranges (External ids 1 and 2) as the profiler writes them,
    each with a ``gpu_user_annotation`` over its kernels on stream 7 when
    it has any (``device_events``: [n1, n2]); a kernel of another stream
    and one outside both spans."""
    ev = []
    for i, n in enumerate(device_events):
        t = 1000.0 * i
        ev.append({"cat": "user_annotation", "name": "shifted_logdet_q",
                   "ts": t, "dur": 50.0, "pid": 1, "tid": 1,
                   "args": {"External id": i + 1}})
        if n:
            ev.append({"cat": "gpu_user_annotation",
                       "name": "shifted_logdet_q", "ts": t + 20,
                       "dur": 10.0 * n, "pid": 0, "tid": 7,
                       "args": {"External id": i + 1}})
        ev += [{"cat": "kernel", "name": "diag_kernel", "ts": t + 20 + 10 * k,
                "dur": 5.0, "pid": 0, "tid": 7} for k in range(n)]
    ev.append({"cat": "kernel", "name": "other", "ts": 22.0, "dur": 1.0,
               "pid": 0, "tid": 8})
    ev.append({"cat": "kernel", "name": "other", "ts": 500.0, "dur": 1.0,
               "pid": 0, "tid": 7})
    return {"traceEvents": ev}


@pytest.mark.parametrize("device_events,launched,whole", [
    ([3, 2], 2, True),
    ([3, 0], 2, False),     # the second call's device events were lost
    ([0, 0], 2, False),     # a session with no device events at all
    ([3, 2], 3, False),     # fewer ranges than launches
])
def test_trace_check_refuses_lost_device_events(tmp_path, device_events,
                                                launched, whole):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump(_fake_trace(device_events), f)
    if whole:
        assert trace.check(path, {"shifted_logdet_q": launched,
                                  "tri_inverse": 0}) == {
            "shifted_logdet_q": device_events}
    else:
        with pytest.raises(RuntimeError, match="lost"):
            trace.check(path, {"shifted_logdet_q": launched})


@pytest.mark.parametrize("lead_in_left,whole", [(5, True), (0, False)])
def test_trace_check_refuses_a_trace_whose_lead_in_was_lost(
        tmp_path, lead_in_left, whole):
    """On the card a session may lose its first device records: the
    lead-in takes that loss, and a trace with none of it left cannot vouch
    for the step's first records."""
    ev = _fake_trace([3, 2])["traceEvents"]
    ev.append({"cat": "user_annotation", "name": trace.LEAD_IN_RANGE,
               "ts": -100.0, "dur": 20.0, "pid": 1, "tid": 1,
               "args": {"External id": 9}})
    if lead_in_left:
        ev.append({"cat": "gpu_user_annotation", "name": trace.LEAD_IN_RANGE,
                   "ts": -90.0, "dur": 10.0 * lead_in_left, "pid": 0,
                   "tid": 7, "args": {"External id": 9}})
        ev += [{"cat": "kernel", "name": "add", "ts": -90.0 + 10 * k,
                "dur": 1.0, "pid": 0, "tid": 7} for k in range(lead_in_left)]
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    if whole:
        got = trace.check(path, {"shifted_logdet_q": 2}, with_lead_in=True)
        assert got[trace.LEAD_IN_RANGE] == [lead_in_left]
    else:
        with pytest.raises(RuntimeError, match="lead-in"):
            trace.check(path, {"shifted_logdet_q": 2}, with_lead_in=True)


def test_profiled_next_that_lost_device_events_raises(tmp_path,
                                                      monkeypatch):
    """A call whose trace lacks the device events of the kernels it
    launched raises, and its trace is kept only as ``*.incomplete``."""
    counts = iter([{"shifted_logdet_q": 0}, {"shifted_logdet_q": 1}])
    monkeypatch.setattr(trace, "kernel_launches", lambda: next(counts))
    prof = tmp_path / "prof"
    ch = get_chooser("GPEIOptChooser", str(tmp_path),
                     f"profile_dir={prof},{ARGS},device=cpu")
    with pytest.raises(RuntimeError, match="lost the call's device events"):
        ch.next(*_problem())
    (name,) = os.listdir(prof)
    assert name.endswith(".pt.trace.json.incomplete")
