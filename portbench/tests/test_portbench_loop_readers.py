"""The readers of the loops' metrics (``lbfgs_idle_s``, ``mcmc_idle_s``,
``lbfgs_useful_pct``) on a synthetic Chrome trace of one suggestion whose
sampler and L-BFGS carry loop ranges, and on the same trace without
them, as a program older than those ranges writes it."""

import pytest

from portbench import harness, tracing

# µs.  Host ranges (user_annotation) and their device spans
# (gpu_user_annotation, same External id); device kernels; host ops.
HOST = [("stage:mcmc", 100, 1000, 1), ("slice:eval", 150, 400, 2),
        ("shifted_logdet_q", 195, 390, 3), ("slice:read", 400, 500, 4),
        ("stage:ei", 1000, 1200, 5), ("stage:lbfgs", 1200, 1600, 6),
        ("lbfgs:grad", 1250, 1350, 7), ("lbfgs:update", 1350, 1500, 8)]
LOOP = {"slice:eval", "slice:read", "lbfgs:grad", "lbfgs:update"}
GPU = {1: (100, 990), 2: (150, 150), 3: (200, 380), 4: (400, 400),
       5: (1000, 1200), 6: (1200, 1600), 7: (1260, 1360),
       8: (1440, 1500)}
KERNELS = [("assemble", 100, 150), ("b1_diag", 200, 300),
           ("b1_trail", 320, 380), ("sampler_where", 480, 990),
           ("ei", 1000, 1050), ("ei", 1150, 1200), ("topk", 1200, 1260),
           ("grad", 1260, 1360), ("update", 1440, 1500),
           ("argmin", 1560, 1600)]
OPS = [("cudaStreamSynchronize", 410, 490)]
# the gaps, their labels, and the metric each goes to
GAPS = {(150, 200): ("slice:eval | python", "mcmc"),
        (300, 320): ("shifted_logdet_q | python", None),
        (380, 480): ("slice:read | cudaStreamSynchronize", "mcmc"),
        (990, 1000): ("stage:mcmc | python", "mcmc"),
        (1050, 1150): ("stage:ei | python", None),
        (1360, 1440): ("lbfgs:update | python", "lbfgs"),
        (1500, 1560): ("stage:lbfgs | python", "lbfgs")}


def events(with_loops=True):
    ev = []
    for name, t0, t1, eid in HOST:
        if name in LOOP and not with_loops:
            continue
        ev.append({"cat": "user_annotation", "name": name, "ts": t0,
                   "dur": t1 - t0, "args": {"External id": eid}})
        g0, g1 = GPU[eid]
        ev.append({"cat": "gpu_user_annotation", "name": name, "ts": g0,
                   "dur": g1 - g0, "pid": 0, "tid": 7,
                   "args": {"External id": eid}})
    for name, t0, t1 in KERNELS:
        ev.append({"cat": "kernel", "name": name, "ts": t0, "dur": t1 - t0,
                   "pid": 0, "tid": 7})
    for name, t0, t1 in OPS:
        ev.append({"cat": "cuda_runtime", "name": name, "ts": t0,
                   "dur": t1 - t0})
    return ev


def view(steps):
    return harness.RunView({}, {}, 40, 2, 1, 100, [],
                           [{"trace": st} for st in steps])


def read(name, v):
    return harness.load_module("metrics", name).read(v)


def expected(metric):
    us = sum(b - a for (a, b), (_, m) in GAPS.items() if m == metric)
    return us * 1e-6


def test_the_gaps_carry_the_loop_ranges():
    st = tracing.reduce_trace(events())
    got = {lab for _, lab in st.gaps}
    assert got == {lab for lab, _ in GAPS.values()}
    assert {"lbfgs:update | python", "slice:read | cudaStreamSynchronize",
            "stage:ei | python"} <= got


@pytest.mark.parametrize("with_loops", [True, False],
                         ids=["loop_ranges", "stage_ranges_only"])
@pytest.mark.parametrize("n_steps", [1, 2])
def test_idle_readers_take_their_own_gaps(with_loops, n_steps):
    """Each gap goes to the metric of its loop or to none (EI's and B1's
    go to neither), per profiled suggestion; a trace without the loop
    ranges labels the same gaps with the stage and reads the same."""
    st = tracing.reduce_trace(events(with_loops))
    if not with_loops:
        assert {lab.split(" | ")[0] for _, lab in st.gaps} == {
            "stage:mcmc", "shifted_logdet_q", "stage:ei", "stage:lbfgs"}
    v = view([st] * n_steps)
    assert read("lbfgs_idle_s", v) == pytest.approx(expected("lbfgs"))
    assert read("mcmc_idle_s", v) == pytest.approx(expected("mcmc"))


def test_idle_readers_read_nothing_without_device_events():
    st = tracing.reduce_trace([e for e in events()
                               if e["cat"] != "kernel"])
    for name in ("lbfgs_idle_s", "mcmc_idle_s"):
        assert read(name, view([st])) is None
        assert read(name, view([])) is None


@pytest.mark.parametrize("counts,want", [
    ({"lbfgs:iters": 200, "lbfgs:useful_iters": 30}, 15.0),
    ({"lbfgs:iters": 50, "lbfgs:useful_iters": 50}, 100.0),
    ({"slice:evals": 7}, None),
    ({}, None),
])
def test_useful_share_reads_the_programs_counters(monkeypatch, counts, want):
    from spearmint_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    got = read("lbfgs_useful_pct", view([]))
    assert got == (None if want is None else pytest.approx(want))


def test_useful_share_of_a_program_without_counters_is_none(monkeypatch):
    from spearmint_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "counters")
    assert read("lbfgs_useful_pct", view([])) is None
