"""``tools/k1_turns.py`` builds its variants of K1 by text edits of this
tree's ``csrc/lstm_recurrence.cu``; each edit has to find its text there
exactly once, or the tool ends on the card before it times anything.  The
variants' builds and timings themselves run only on the card."""

import os

import pytest

from xna_basecaller_tpu_torch.ops import _build
from xna_basecaller_tpu_torch.tools import k1_turns


def _source() -> str:
    with open(os.path.join(_build.CSRC, "lstm_recurrence.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name", [*k1_turns.VARIANTS,
                                  *k1_turns.F32_VARIANTS])
def test_k1_turns_variant_edits_apply_once(name):
    edits = {**k1_turns.VARIANTS, **k1_turns.F32_VARIANTS}[name]
    text = _source()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    assert text != _source()
