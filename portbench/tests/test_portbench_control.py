"""The controls at a tiny size on the CPU: the precision below the
configuration's bf16 reads wider gaps than the program's own path on the
same seeds.  At the cells' own sizes the controls are read on the card by
``python3 -m portbench.calibrate`` (their readings and the limits set from
them are in ``portbench/limits/``)."""

import pytest

from portbench.kinds import basecall, train
from portbench.reference.judge import train_gaps, train_reference
from portbench.reference.model import fp8_mm
from portbench.weights import make_weights

SEEDS = [2 ** 31 + 41, 2 ** 31 + 42]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_int8_path_reads_wider_gaps(seed, basecall_cell):
    readings = []
    for control in (False, True):
        s = basecall.setup(basecall_cell, seed, "cpu", control=control)
        s.window(0.5)
        s.check()
        readings.append(float(s.gaps.max()))
    sound, low = readings
    assert low > sound and low > 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_the_fp8_reference_reads_wider_gaps(seed, train_cell):
    s = train.setup(train_cell, seed, "cpu")
    s.window(0.5)
    sound = s.check()
    t, model = train_cell["traffic"], train_cell["config"]["model"]
    w = make_weights(model, seed, "cpu")
    args = (model, s.first, t["lr"], t["weight_decay"], t["clip"], "cpu")
    low = train_gaps(train_reference(w, *args, mm=fp8_mm),
                     train_reference(w, *args))
    assert low["loss1"] > sound["loss1"]
    assert low["grad_diff"] > sound["grad_diff"]
