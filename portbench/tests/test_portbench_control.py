"""The control comes out not correct, on the card at the cell's size.

The control is the reference in TF32, put in the program's place on the
same timed calls (``check.control``).  Run on the card with
``python -m pytest --noconftest -m gpu portbench/tests/test_portbench_control.py``
(about a minute a cell); without a card it skips."""

import pytest

from portbench import cell as cellmod
from portbench import check, harness
from portbench.tests.conftest import ROOT

CELLS = ("opt.n5000.noisefree", "per_sec.n5000.noisefree")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size (5000 observations, float64 reference)")
    from spearmint_tpu_torch.ops import build

    build.build_all()
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload, card):
    c = cellmod.load_cell(workload, ROOT)
    out = harness.run_cell(c, 2 ** 31 + 77, 0.0, False, card, [],
                           calls_only=3, with_control=True)
    limits = c.config["limits"]
    assert out["correct"], out["checks"]
    ctl = out["control"]
    assert any(not ctl[k] <= limits[k] for k in ctl), ctl
    assert not check.verdict({**ctl, "unmoved_share": 0.0,
                              "persist_misses": 0.0}, limits)
