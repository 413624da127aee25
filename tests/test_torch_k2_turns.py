"""``tools/k2_turns.py`` builds its variants of the decode's wide path by
text edits of this tree's ``csrc/crf_decode.cu``; each edit has to find
its text there exactly once.  Its byte counts are the benchmark's
(``portbench/crf_work.py``), and its inputs at the first path's shapes,
which ``tests/test_torch_kernels_gpu.py`` holds the kernels' digests to,
are the same on every machine.  The builds and timings run only on the
card."""

import os

import numpy as np
import pytest

from portbench import crf_work
from xna_basecaller_tpu_torch.ops import _build
from xna_basecaller_tpu_torch.tools import k2_turns


def _source() -> str:
    with open(os.path.join(_build.CSRC, "crf_decode.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name", list(k2_turns.VARIANTS))
def test_k2_turns_variant_edits_apply_once(name):
    text = _source()
    for old, new in k2_turns.VARIANTS[name]:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert text != _source()


def test_k2_turns_bytes_are_the_benchmarks():
    mine = k2_turns.chain_bytes(2000, 256, 4, 1024)
    theirs = crf_work.k2_bytes(2000, 256, 4, 1024)
    assert {k.lower(): v for k, v in mine.items()} == theirs
    assert crf_work.k2_bound_s(2000, 256, 4, 1024) * 1e3 == pytest.approx(
        7.67, abs=0.005)


def test_first_path_inputs_are_integer_thousandths():
    s = k2_turns.first_path_inputs(6, 3)
    assert tuple(s.shape) == (k2_turns.FIRST_T, k2_turns.FIRST_N, 216 * 7)
    thousandths = s.numpy().astype(np.float64) * 1000
    assert np.abs(thousandths - np.round(thousandths)).max() < 1e-3
    assert float(s.abs().max()) <= 5.0
    assert np.array_equal(s.numpy(), k2_turns.first_path_inputs(6, 3).numpy())
