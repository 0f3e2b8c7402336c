"""A run whose timed path is broken underneath reads ``correct`` false.

Each test drives the rest of a run (the harness on the CPU, a tiny cut of
the cell with its own limits) with one of ``faults.FAULTS`` planted in
the program: a sampler that returns its state unchanged, the sample
average taken over half of the samples, and an answer altered where it
is produced.  The cell runs on one card, so no exchange between chips can
be left out."""

import pytest

from portbench import faults, harness
from portbench.tests.conftest import tiny

CELLS = ("opt.n5000.noisefree", "per_sec.n5000.noisefree")


def run(workload, seed=5):
    return harness.run_cell(tiny(workload), seed, 0.0, False, "cpu", [],
                            calls_only=2)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_reads_incorrect(workload, fault):
    undo = faults.plant(fault)
    try:
        out = run(workload)
    finally:
        undo()
    assert not out["correct"], out["checks"]
