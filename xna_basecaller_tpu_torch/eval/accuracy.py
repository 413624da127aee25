"""Copied from ``xna_basecaller_tpu/eval/accuracy.py``; only the package
imports differ (the native branch calls this package's
``utils/native.py``).

Local alignment accuracy for train-time validation.

Replaces the reference's parasail Smith-Waterman call (reference:
ub-bonito/bonito/util.py:402-424: sw_trace_striped_32(seq, ref, 8, 4,
dnafull) -> cigar identity %).  Scoring follows the dnafull convention for
the characters that matter here: match +5, mismatch -4, 'N' scores -2
against everything, gap open 8 / extend 4.  The UB letters X/Y are scored
as first-class bases (match +5 / mismatch -4) rather than inheriting
IUPAC-ambiguity rows — a deliberate deviation documented here because the
reference's 'Y' collided with the IUPAC pyrimidine code in dnafull.

The DP is anti-diagonal-free, row-vectorised numpy (sequences are <1 kb
chunks); a native SIMD path can replace it transparently.
"""

from __future__ import annotations

import numpy as np

from xna_basecaller_tpu_torch.utils import native

MATCH = 5
MISMATCH = -4
N_SCORE = -2
GAP_OPEN = 8
GAP_EXTEND = 4
NEG = -10 ** 8


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("ascii"), dtype=np.uint8)


def sw_align(query: str, ref: str):
    """Smith-Waterman with affine gaps; returns (score, cigar ops, bounds).

    cigar ops is a list of (op, count) with ops in '=XID' covering the local
    aligned region; bounds = (q_start, q_end, r_start, r_end) exclusive-end.
    Backed by the native C++ kernel when available (same DP and
    tie-breaking); this numpy version is the fallback/oracle.
    """
    if native.available():
        return native.sw_align(query, ref)
    q = _codes(query)
    r = _codes(ref)
    nq, nr = len(q), len(r)
    if nq == 0 or nr == 0:
        return 0, [], (0, 0, 0, 0)

    is_n_q = q == ord("N")
    is_n_r = r == ord("N")

    H = np.zeros((nq + 1, nr + 1), np.int32)
    E = np.full(nr + 1, NEG, np.int32)  # gap in query (deletion from ref)
    # traceback: 0 stop, 1 diag, 2 up (I: consumes query), 3 left (D)
    TB = np.zeros((nq + 1, nr + 1), np.uint8)
    TE = np.zeros((nq + 1, nr + 1), bool)  # E extended
    TF = np.zeros((nq + 1, nr + 1), bool)  # F extended

    best = 0
    best_pos = (0, 0)
    F_row = np.full(nr + 1, NEG, np.int32)
    for i in range(1, nq + 1):
        sub = np.where(
            is_n_q[i - 1] | is_n_r, N_SCORE,
            np.where(r == q[i - 1], MATCH, MISMATCH)).astype(np.int32)
        diag = H[i - 1, :-1] + sub
        # F: gap consuming query (vertical) — vectorised across j
        F_open = H[i - 1, 1:] - GAP_OPEN
        F_ext = F_row[1:] - GAP_EXTEND
        F_new = np.maximum(F_open, F_ext)
        TF[i, 1:] = F_ext >= F_open
        F_row[1:] = F_new
        # E: gap consuming ref (horizontal) — sequential in j
        h_prev = H[i]
        e = NEG
        row = H[i]
        tb_row = TB[i]
        te_row = TE[i]
        for j in range(1, nr + 1):
            e_open = row[j - 1] - GAP_OPEN
            e_ext = e - GAP_EXTEND
            e = max(e_open, e_ext)
            te_row[j] = e_ext >= e_open
            h = max(0, diag[j - 1], F_new[j - 1], e)
            row[j] = h
            if h == 0:
                tb_row[j] = 0
            elif h == diag[j - 1]:
                tb_row[j] = 1
            elif h == e:
                tb_row[j] = 3
            else:
                tb_row[j] = 2
            if h > best:
                best = h
                best_pos = (i, j)

    if best == 0:
        return 0, [], (0, 0, 0, 0)

    # traceback
    i, j = best_pos
    q_end, r_end = i, j
    ops: list[str] = []
    while i > 0 and j > 0 and TB[i, j] != 0:
        t = TB[i, j]
        if t == 1:
            same = q[i - 1] == r[j - 1] and not (is_n_q[i - 1] or is_n_r[j - 1])
            ops.append("=" if same else "X")
            i -= 1
            j -= 1
        elif t == 2:
            ops.append("I")
            i -= 1
        else:
            ops.append("D")
            j -= 1
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return int(best), [(o, c) for o, c in cigar], (i, q_end, j, r_end)


def accuracy(ref: str, seq: str, balanced: bool = False,
             min_coverage: float = 0.0) -> float:
    """Identity % between ref and basecall (reference util.py:402-424).

    min_coverage gates on the fraction of the reference covered by the
    local alignment.
    """
    if not seq or not ref:
        return 0.0
    _, cigar, (q0, q1, r0, r1) = sw_align(seq, ref)
    if not cigar:
        return 0.0
    if (r1 - r0) / len(ref) < min_coverage:
        return 0.0
    counts = {"=": 0, "X": 0, "I": 0, "D": 0}
    for op, c in cigar:
        counts[op] += c
    denom_ops = (counts["="] + counts["X"] + counts["D"]) if balanced else (
        counts["="] + counts["I"] + counts["X"] + counts["D"])
    if denom_ops == 0:
        return 0.0
    if balanced:
        acc = (counts["="] - counts["I"]) / denom_ops
    else:
        acc = counts["="] / denom_ops
    return acc * 100.0


def print_alignment(ref: str, seq: str, file=None, width: int = 80) -> int:
    """Pretty-print the local alignment between ref and basecall and
    return its score (reference util.py:427-437; parasail traceback
    rendering replaced by the built-in SW cigar)."""
    import sys

    file = file or sys.stdout
    score, cigar, (q0, _, r0, _) = sw_align(seq, ref)
    r_line: list[str] = []
    c_line: list[str] = []
    q_line: list[str] = []
    qi, ri = q0, r0
    for op, count in cigar:
        for _ in range(count):
            if op in ("=", "X"):
                r_line.append(ref[ri])
                q_line.append(seq[qi])
                c_line.append("|" if op == "=" else ".")
                ri += 1
                qi += 1
            elif op == "I":  # consumes query
                r_line.append("-")
                q_line.append(seq[qi])
                c_line.append(" ")
                qi += 1
            else:  # 'D' consumes ref
                r_line.append(ref[ri])
                q_line.append("-")
                c_line.append(" ")
                ri += 1
    for start in range(0, len(r_line), width):
        sl = slice(start, start + width)
        print("".join(r_line[sl]), file=file)
        print("".join(c_line[sl]), file=file)
        print("".join(q_line[sl]), file=file)
    print(f"  Score={score}", file=file)
    return score
