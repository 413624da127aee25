"""The R10.4.1 sup basecall cell at a tiny size on the CPU, held to its
own limits: a sound run is correct, and the fp8 control
(``portbench/calibrate_fp8.py``) reads wider gaps on the same reads."""

import pytest

from portbench import calibrate_fp8, run
from portbench.tests.conftest import make_cell

SEED = 2 ** 31 + 77
R10 = {"kind": "basecall", "pool_reads": 4,
       "length": {"dist": "uniform", "low": 900, "high": 2000},
       "ub_per_read": 0, "samples_per_base": 10.0, "check_reads": 3,
       "check_rows": 8}


@pytest.fixture
def r10_cell(tmp_path):
    cell = make_cell(tmp_path, R10, "dna_r10_sup.basecall",
                     config="dna_r10.4.1_sup_v4.0.0")
    cell["config"]["model"]["basecaller"].update(chunksize=500, overlap=50,
                                                 batchsize=4)
    return cell


def test_the_r10_cell_is_correct(r10_cell):
    result = run.run_cell(r10_cell, SEED, 1.0, trace=False, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_fp8_control_reads_wider_gaps(seed, r10_cell):
    out = calibrate_fp8.reading(r10_cell, seed, 0.5, "cpu")
    sound, low = out["numbers"], out["control_numbers"]
    assert out["frames"][0] == out["frames"][1] > 0
    assert low["frames_over_2nats"] > sound["frames_over_2nats"]
