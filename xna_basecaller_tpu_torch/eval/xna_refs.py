"""Copied from ``xna_basecaller_tpu/eval/xna_refs.py``: ``read_fasta``
only.  The template libraries (``XnaRefs``, ``identify_ref`` and the
``xna_libs`` assets) are not ported yet.
"""

from __future__ import annotations


def read_fasta(path: str) -> dict[str, str]:
    out: dict[str, str] = {}
    name = None
    seq: list[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(seq)
                name = line[1:].split()[0]
                seq = []
            elif line:
                seq.append(line)
    if name is not None:
        out[name] = "".join(seq)
    return out
