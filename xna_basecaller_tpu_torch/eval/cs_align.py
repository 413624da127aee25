"""Copied from ``xna_basecaller_tpu/eval/cs_align.py``: ``parse_cs``
only, which the SAM writer's CIGAR needs.  The rest of the alignment
forensics (target matches, polish, error vectors, demux) is not ported
yet.
"""

from __future__ import annotations

import re

CS_REGEX = re.compile(
    r":[0-9]+|\*[a-zA-Z]{2}|[=+-][A-Za-z]+|~[a-z]{2}[0-9]+[a-z]{2}")


def parse_cs(cs: str) -> list[str]:
    """Split a cs tag into operations (reference utils.py:87-110)."""
    return CS_REGEX.findall(cs)
