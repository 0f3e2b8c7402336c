"""The manifest's cells, metrics and kernels are files found by name."""

import json
import os
import re

import pytest

from portbench import cell as cellmod
from portbench import harness
from portbench.tests.conftest import ROOT

MANIFEST = cellmod.load_manifest(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KERNELS = ("shifted_logdet_q", "shifted_factor_logdet_q", "tri_inverse",
           "logdet_q", "factor_logdet_q", "cr_logdet_q")


def test_manifest_has_exactly_its_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("w", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_files_load_by_name(w):
    c = cellmod.load_cell(w, ROOT)
    assert c.chips == 1
    assert set(c.config["limits"]) >= {"lp_gap", "ei_gap", "opt_gap",
                                        "answer_gap", "unmoved_share",
                                        "persist_misses"}
    args = cellmod.chooser_args(c.config, 5, "cpu")
    assert args["seed"] == 5 and args["device"] == "cpu"
    assert c.traffic["completed"] > 0 and c.traffic["profiled_calls"] >= 1


def test_names_units_and_bounds():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["layer"]


@pytest.mark.parametrize("m", [m["name"] for m in MANIFEST["per_layer"]])
def test_every_per_layer_metric_has_its_reader(m):
    assert callable(harness.load_module("metrics", m).read)


@pytest.mark.parametrize("k", KERNELS)
def test_every_kernel_wrapper_has_its_roofline(k):
    r = harness.load_module("rooflines", k)
    assert r.ops(10, 5000) > 0 and r.bytes_moved(10, 5000) > 0


@pytest.mark.parametrize("conf", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_reduced_keys_differ_from_the_source(conf):
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert set(conf["reduced"]) == set(cfg["source_values"])
    for k in conf["reduced"]:
        assert cfg[k] != cfg["source_values"][k]
