"""The table of the port's C entry points (``ops/_build.py::ENTRY_POINTS``)
against the CUDA sources: each entry point is defined once in the source
the table names, with as many parameters as the table gives argument
types.  The types live in one place on the Python side, so this catches a
C signature that changed without the table.  Reads the sources; builds
nothing."""

import os
import re

import pytest

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
    if e.path:
        assert "".join(params[-1].split()).startswith("int*"), params[-1]
