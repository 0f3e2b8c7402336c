"""Nothing the benchmark runs loads JAX, flax or the JAX package, the
reference loads nothing of the program, and a run with no card prints no
result."""

import ast
import json
import os
import subprocess
import sys

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "spearmint_tpu"}
DRIVE = r"""
import json, sys
sys.path.insert(0, {root!r})
from portbench.tests.conftest import tiny
from portbench import cell as cellmod, harness, run
m = cellmod.load_manifest({root!r})
for w in ("opt.n5000.noisefree", "per_sec.n5000.noisefree"):
    out = harness.run_cell(tiny(w), 3, 0.0, True, "cpu", m["per_layer"],
                           calls_only=1)
    assert out["correct"], out
print(json.dumps({{"top": sorted({{k.split(".")[0] for k in sys.modules}}),
                   "found": run.forbidden_modules()}}))
"""


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", DRIVE.format(root=ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["found"] == []
    # compared by whole top-level names: the port's name begins with the
    # JAX package's, and it is loaded
    assert "spearmint_tpu_torch" in got["top"]
    assert not FORBIDDEN & set(got["top"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "portbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            got = set(_imports(os.path.join(ref, f)))
            assert got <= {"__future__", "math", "typing", "numpy", "scipy",
                           "torch"}, (f, got)


def test_no_source_of_the_benchmark_imports_jax():
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py"):
                assert not FORBIDDEN & set(_imports(os.path.join(d, f))), f


def test_no_card_no_result(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "opt.n5000.noisefree",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
