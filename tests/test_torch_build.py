"""The table of the port's C entry points (``ops/_build.py::ENTRY_POINTS``)
against the CUDA sources: each entry point is defined once in the source
the table names, with as many parameters as the table gives argument
types.  The types live in one place on the Python side, so this catches a
C signature that changed without the table.  Reads the sources; builds
nothing.  And ``_build.launch``'s counts of the path a launch reports,
with the entry point faked."""

import os
import re
import types

import pytest
import torch

from xna_basecaller_tpu_torch.ops import _build


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_entry_point_matches_its_source(name):
    e = _build.ENTRY_POINTS[name]
    with open(os.path.join(_build.CSRC, e.source + ".cu")) as f:
        text = f.read()
    found = re.findall(rf"\bint\s+{name}\s*\(([^)]*)\)\s*{{", text)
    assert len(found) == 1, (name, e.source, len(found))
    params = [p for p in found[0].split(",") if p.strip() not in ("", "void")]
    assert len(params) == len(e.argtypes), (name, params)
    # a launch that reports a path takes the int it sets last
    if e.paths:
        assert "".join(params[-1].split()).startswith("int*"), params[-1]


@pytest.mark.parametrize("took,path", [(0, None), (1, "wide"),
                                       (2, "split")])
def test_launch_counts_the_path_the_launch_reports(monkeypatch, took, path):
    """K1's launch sets its last argument to the geometry it took (0
    Narrow, 1 Wide, 2 Split): ``launches["lstm_recurrence.<path>"]``
    counts it by the table's ``paths``, every launch counts in
    ``launches["lstm_recurrence"]``."""
    def fake(*args):
        args[-1]._obj.value = took   # the int passed by reference
        return 0
    monkeypatch.setattr(_build, "entry", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "launches", _build.collections.Counter())
    _build.launch("lstm_recurrence", "xna_lstm_recurrence", *[0] * 12)
    assert _build.ENTRY_POINTS["xna_lstm_recurrence"].paths == (
        "wide", "split")
    want = {"lstm_recurrence": 1, **({f"lstm_recurrence.{path}": 1}
                                      if path else {})}
    assert dict(_build.launches) == want
