"""Copied from ``xna_basecaller_tpu/core/alphabet.py``;
only the package imports differ.

Alphabet for expanded-base (XNA) basecalling.

The framework basecalls DNA containing Unnatural Bases (UBs): an extra base
pair X/Y (Ds-Px) on top of the canonical A,C,G,T.  Integer codes follow the
reference ctc-data contract (reference: ub-bonito/bonito/spike_chunks.py:7 and
io.py:539-540): N=0, A=1, C=2, G=3, T=4, X=5, Y=6.  Code 0 ("N") doubles as
the CTC blank/stay label.
"""

from __future__ import annotations

import numpy as np

# Canonical 7-letter alphabet (6-base models).  5-letter models (single UB)
# use BASES_5 = "NACGTX"; plain DNA models use BASES_4 = "NACGT".
BASES = "NACGTXY"
BASES_5 = "NACGTX"
BASES_4 = "NACGT"

CODE = {c: i for i, c in enumerate(BASES)}

# Complement map aware of the unnatural pair: X complements Y (Ds-Px pairing),
# mirroring reference src/misc/utils.py:26-59 reverse-complement behaviour.
COMPLEMENT = {
    "N": "N", "A": "T", "C": "G", "G": "C", "T": "A", "X": "Y", "Y": "X",
    "-": "-", "*": "*",  # alignment-state chars pass through (utils.py:28)
}

_COMP_CODES = np.array([CODE[COMPLEMENT[c]] for c in BASES], dtype=np.uint8)


def n_base(alphabet: str | list) -> int:
    """Number of real bases (alphabet minus the blank 'N')."""
    return len(alphabet) - 1


def encode(seq: str, alphabet: str = BASES) -> np.ndarray:
    """String -> uint8 codes."""
    lut = np.zeros(256, dtype=np.uint8)
    for i, c in enumerate(alphabet):
        lut[ord(c)] = i
    return lut[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def decode(codes, alphabet: str = BASES, drop_blank: bool = True) -> str:
    """Integer codes -> string, dropping blanks (code 0) by default.

    Mirrors reference util.decode_ref (ub-bonito/bonito/util.py:134-138).
    """
    codes = np.asarray(codes)
    if drop_blank:
        codes = codes[codes != 0]
    lut = np.frombuffer("".join(alphabet).encode("ascii"), dtype=np.uint8)
    return lut[codes].tobytes().decode("ascii")


def reverse_complement_str(seq: str) -> str:
    """X/Y-aware reverse complement of a base string."""
    return "".join(COMPLEMENT[c] for c in reversed(seq))


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """X/Y-aware reverse complement of integer codes."""
    return _COMP_CODES[np.asarray(codes)][::-1].copy()
