"""The trace arithmetic and the metric readers on a synthetic Chrome
trace of one suggestion."""

import json

import pytest

from portbench import harness, peaks, tracing

# µs.  Host ranges (user_annotation) and their device spans
# (gpu_user_annotation, same External id); device kernels.
HOST = [("trace:lead_in", 0, 50, 9), ("stage:mcmc", 100, 1000, 1),
        ("shifted_logdet_q", 200, 400, 2), ("shifted_logdet_q", 500, 700, 3),
        ("stage:caches", 1000, 1100, 4),
        ("shifted_factor_logdet_q", 1010, 1090, 5),
        ("stage:ei", 1100, 1200, 6), ("stage:lbfgs", 1200, 1500, 7)]
GPU = {9: (10, 60), 1: (150, 900), 2: (210, 390), 3: (520, 690),
       4: (1000, 1100), 5: (1020, 1080), 6: (1110, 1190), 7: (1250, 1480)}
KERNELS = [("lead", 10, 60), ("assemble", 150, 200), ("b1_diag", 210, 300),
           ("b1_trail", 300, 390), ("assemble", 450, 500),
           ("b1_diag", 520, 690), ("sampler_where", 880, 900),
           ("assemble", 1000, 1020), ("b2", 1020, 1080),
           ("ei", 1110, 1190), ("lbfgs", 1250, 1300), ("lbfgs", 1400, 1480)]
OPS = [("aten::item", 390, 450), ("cudaStreamSynchronize", 700, 880),
       ("aten::item", 1300, 1400)]


def events():
    ev = []
    for name, t0, t1, eid in HOST:
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
        cat = "cuda_runtime" if name.startswith("cuda") else "cpu_op"
        ev.append({"cat": cat, "name": name, "ts": t0, "dur": t1 - t0})
    return ev


@pytest.fixture
def step():
    return tracing.reduce_trace(events())


def view(step, n=40, chains=2):
    return harness.RunView({}, {}, n, chains, 1, 100,
                           [{"wall_s": 1.0, "latency_s": 0.75,
                             "launched": {"shifted_logdet_q": 4}},
                            {"wall_s": 2.0, "latency_s": 1.75,
                             "launched": {"shifted_logdet_q": 6}}],
                           [{"trace": step}])


def test_window_busy_and_gaps(step):
    assert step.window == (100, 1500)
    busy = sum(b - a for _, a, b in KERNELS[1:])
    assert step.busy_us == busy
    assert sum(us for us, _ in step.gaps) == 1400 - busy
    gaps = {}
    for us, label in step.gaps:
        gaps[label] = gaps.get(label, 0) + us
    assert gaps["stage:mcmc | cudaStreamSynchronize"] == 190
    assert gaps["stage:lbfgs | aten::item"] == 100
    assert gaps["shifted_logdet_q | python"] == 10 + 20


def test_union_and_ranges():
    assert tracing.union([(0, 10), (5, 20), (30, 40)]) == 30
    spans = tracing.device_spans(events())
    assert spans["shifted_logdet_q"] == [(210, 390), (520, 690)]
    assert spans["stage:mcmc"] == [(150, 900)]


def test_readers(step):
    v = view(step)

    def read(m):
        return harness.load_module("metrics", m).read(v)

    assert read("mcmc_s") == pytest.approx(750e-6)
    assert read("acq_s") == pytest.approx((100 + 80 + 230) * 1e-6)
    # inside mcmc's span, outside the wrappers: 50 + 50 + 20 µs, 2 B1s
    assert read("assembly_ms") == pytest.approx(0.120 / 2)
    assert read("device_idle_pct") == pytest.approx(
        100 * (1 - step.busy_us / 1400))
    assert read("chooser_host_s") == pytest.approx(0.25)
    assert read("slice_evals") == pytest.approx(5.0)
    b1 = harness.load_module("rooflines", "shifted_logdet_q")
    need = peaks.bound_s(b1.ops(2, 40), b1.bytes_moved(2, 40))
    assert read("b1_roofline_pct") == pytest.approx(
        100 * need * 2 / 350e-6)
    b2 = harness.load_module("rooflines", "shifted_factor_logdet_q")
    ops = 2 * b1.ops(2, 40) + b2.ops(2, 40) + 2 * (40 * 40 * 100
                                                   + 2 * 40 * 100)
    assert read("step_mfu") == pytest.approx(
        100 * ops / (1400e-6 * peaks.F32_FLOPS))


def test_readers_find_nothing_without_device_events():
    host_only = [e for e in events() if e["cat"] not in ("kernel",
                                                         "gpu_user_annotation")]
    v = view(tracing.reduce_trace(host_only))
    for m in ("mcmc_s", "acq_s", "assembly_ms", "b1_roofline_pct",
              "device_idle_pct", "step_mfu"):
        assert harness.load_module("metrics", m).read(v) is None, m


def test_breakdown(step, tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events()}))
    b = tracing.breakdown([tracing.read_step(str(p))])
    assert b["device_ops"][0][0] == "b1_diag"
    assert b["device_ops"][0][1] == pytest.approx(260e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0][0] == "stage:mcmc | cudaStreamSynchronize"
