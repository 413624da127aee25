"""Each fault a cell can have, planted under a tiny run on the CPU, turns
``correct`` false; the same run without it is correct.  The cells' own
limits are used."""

import pytest

from portbench import faults, run

SEED = 2 ** 31 + 3


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_basecall"])
def test_a_basecall_fault_is_not_correct(fault, basecall_cell):
    with faults.FAULTS[fault]():
        result = run.run_cell(basecall_cell, SEED, 1.0, trace=False,
                              device="cpu")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_train"])
def test_a_training_fault_is_not_correct(fault, train_cell):
    with faults.FAULTS[fault]():
        result = run.run_cell(train_cell, SEED, 0.5, trace=False,
                              device="cpu")
    assert result["correct"] is False, result["checks"]


def test_a_state_left_unchanged_reads_one():
    from portbench.reference.judge import train_gaps
    import torch
    g = {"a": torch.ones(3), "b": torch.full((3,), 2.0)}
    ref = {"losses": [3.0], "grad1": g, "change": {"a": 0.1, "b": 0.2}}
    prog = {"losses": [3.0], "grad1": g, "change": {"a": 0.0, "b": 0.0}}
    assert train_gaps(prog, ref)["change"] == pytest.approx(1.0)
