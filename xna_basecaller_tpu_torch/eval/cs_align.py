"""Copied from ``xna_basecaller_tpu/eval/cs_align.py``.

Alignment forensics: cs-tag parsing, target-match reconstruction,
UB-aware polish, error vectors and UB metrics, barcode demux.

Re-implements the reference's misc.utils alignment toolkit (reference:
src/misc/utils.py — parse_cs_flag:87, compute_target_matches:377,
polish_target_matches:661, compute_errors_paf:727, barcode demux
get_barcode_match_score:1387).  Works on PAF-like records carrying the
minimap2 ``cs`` short tag; the tags can come from minimap2 itself or from
this framework's built-in Smith-Waterman aligner (eval/ref_align.py).
"""

from __future__ import annotations

import re

import numpy as np

from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
from xna_basecaller_tpu_torch.utils import native

CS_REGEX = re.compile(
    r":[0-9]+|\*[a-zA-Z]{2}|[=+-][A-Za-z]+|~[a-z]{2}[0-9]+[a-z]{2}")


def parse_cs(cs: str) -> list[str]:
    """Split a cs tag into operations (reference utils.py:87-110)."""
    return CS_REGEX.findall(cs)


def compute_target_matches(target: str, operations, align_start: int,
                           align_end: int) -> np.ndarray:
    """Per-target-position alignment state (reference utils.py:377-437):
    the target base where matched, '*' where substituted, '-' where
    deleted/unaligned."""
    tm = np.asarray(list(target))
    tm[:align_start] = "-"
    tm[align_end:] = "-"
    ptr = align_start
    for op in operations:
        sym, val = op[0], op[1:]
        if sym == "=":
            ptr += len(val)
        elif sym == ":":
            ptr += int(val)
        elif sym == "*":
            tm[ptr] = "*"
            ptr += 1
        elif sym == "+":
            pass
        elif sym == "-":
            tm[ptr:ptr + len(val)] = "-"
            ptr += len(val)
        else:
            raise NotImplementedError(op)
    return tm


def compute_read_matches(read_seq: str, operations, align_start: int,
                         align_end: int, target_length: int) -> np.ndarray:
    """Read projected onto target coordinates with query substitutions
    (reference utils.py:112-190): what the basecall said at each target
    position ('-' where nothing aligned)."""
    seq = list(read_seq)
    out: list[str] = ["-"] * align_start
    ptr = 0
    for op in operations:
        sym, val = op[0], op[1:]
        if sym == "=":
            out += seq[ptr:ptr + len(val)]
            ptr += len(val)
        elif sym == ":":
            out += seq[ptr:ptr + int(val)]
            ptr += int(val)
        elif sym == "*":
            out.append(seq[ptr])
            ptr += 1
        elif sym == "+":
            ptr += len(val)
        elif sym == "-":
            out += ["-"] * len(val)
        else:
            raise NotImplementedError(op)
    out += ["-"] * (target_length - align_end)
    return np.asarray(out)


def aligned_pair(record: dict, target: str,
                 read_seq: str) -> tuple[str, str]:
    """Gapped (read_aligned, target_aligned) strings reconstructed from the
    cs operations (reference compute_alignments, utils.py:262-375): equal
    length, '-' in the read at deletions/unaligned target flanks, '-' in
    the target at read insertions, and the full target visible outside the
    aligned window."""
    ra: list[str] = ["-"] * record["target_start"]
    ta: list[str] = list(target[:record["target_start"]])
    r, t = 0, record["target_start"]
    for op in parse_cs(record["cs"]):
        sym, val = op[0], op[1:]
        if sym in (":", "="):
            ln = int(val) if sym == ":" else len(val)
            ra += list(read_seq[r:r + ln])
            ta += list(read_seq[r:r + ln])
            r += ln
            t += ln
        elif sym == "*":
            ra.append(read_seq[r])
            ta.append(val[0].upper())
            r += 1
            t += 1
        elif sym == "+":
            ra += list(read_seq[r:r + len(val)])
            ta += ["-"] * len(val)
            r += len(val)
        elif sym == "-":
            ra += ["-"] * len(val)
            ta += list(target[t:t + len(val)])
            t += len(val)
        else:
            raise NotImplementedError(op)
    ra += ["-"] * (record["target_length"] - record["target_end"])
    ta += list(target[t:])
    assert len(ra) == len(ta)
    return "".join(ra), "".join(ta)


def polish_target_matches(target_matches: np.ndarray,
                          target: str) -> np.ndarray:
    """Fix minimap2's UB-adjacent indel misplacement (reference
    utils.py:661-725): when the called UB sits just off its true position
    next to a gap, move it onto the UB position."""
    ub = "X"  # matches/target are always forward coordinates
    pol = target_matches.copy()
    n = len(pol)
    for m in re.finditer(ub, target):
        p = m.start()
        if target_matches[p] == ub:
            continue
        if target_matches[p] == "-":
            left = right = p
            while left > 0 and target_matches[left - 1] == "-":
                left -= 1
            while right < n - 1 and target_matches[right + 1] == "-":
                right += 1
            if left != 0 and target_matches[left - 1] == ub:
                pol[left - 1] = "-"
                pol[p] = ub
            elif right != n - 1 and target_matches[right + 1] == ub:
                pol[right + 1] = "-"
                pol[p] = ub
        elif (p > 0 and p < n - 1 and target_matches[p - 1] == "-"
              and target_matches[p + 1] == ub):
            pol[p - 1] = pol[p]
            pol[p] = ub
            pol[p + 1] = "-"
        elif (p > 0 and p < n - 1 and target_matches[p + 1] == "-"
              and target_matches[p - 1] == ub):
            pol[p + 1] = pol[p]
            pol[p] = ub
            pol[p - 1] = "-"
    return pol


def compute_errors(record: dict, target: str, read_seq: str | None = None,
                   polish: bool = True, ignore_n: bool = False):
    """Per-target-position error vector for one alignment record
    (reference compute_errors_paf, utils.py:727-770).

    record needs: cs, target_start, target_end, target_length, strand.
    Returns (errors ordered in read direction, target_matches forward).
    """
    ops = parse_cs(record["cs"])
    if read_seq is None:
        tm = compute_target_matches(
            target, ops, record["target_start"], record["target_end"])
    else:
        tm = compute_read_matches(
            read_seq, ops, record["target_start"], record["target_end"],
            record["target_length"])
    if polish:
        tm = polish_target_matches(tm, target)
    errors = (np.asarray(list(target)) != tm).astype(float)
    if ignore_n:
        for m in re.finditer("N", target):
            errors[m.start()] = 0
    if record["strand"] in ("-", "R"):
        errors = errors[::-1]
    return errors, tm


def ub_metrics(errors: np.ndarray, target_matches: np.ndarray, target: str,
               record: dict, kmer_len: int = 6) -> dict:
    """UB-area accuracy / detection metrics for one read (reference
    utils.py:812-940 inside compute_error_rate_per_pos_paf)."""
    x_positions = [m.start() for m in re.finditer("[NXY]", target)]
    n = len(target)
    ub_area_mask = np.zeros(n, bool)
    for p in x_positions:
        ub_area_mask[max(0, p + 1 - kmer_len): p + kmer_len] = True
    ub_area_mask[x_positions] = False
    inclusive = ub_area_mask.copy()
    inclusive[x_positions] = True

    if record["strand"] in ("R", "-"):
        ub_area_mask = ub_area_mask[::-1]
        inclusive = inclusive[::-1]
        x_positions = [n - p - 1 for p in x_positions[::-1]]

    ub_area_matches = int(np.logical_not(errors[ub_area_mask]).sum())
    ub_area_len = int(ub_area_mask.sum())
    ub_matches = int(np.logical_not(errors[x_positions]).sum())
    ub_len = len(x_positions)

    ubs_detected = int(np.isin(target_matches, ["X", "Y"]).sum())
    false_ubs = ubs_detected - ub_matches
    fdr = false_ubs / ubs_detected if ubs_detected > 0 else np.nan
    fpr = false_ubs / (n - ub_len) if n > ub_len else np.nan

    non_mask = ~inclusive
    non_matches = int(np.logical_not(errors[non_mask]).sum())
    non_len = int(non_mask.sum())

    per_pos_ub, per_pos_area = [], []
    for p in x_positions:
        m_ub = int(not errors[p])
        sl = slice(max(0, p + 1 - kmer_len), p + kmer_len)
        m_area = int(np.logical_not(errors[sl]).sum()) - m_ub
        per_pos_ub.append(m_ub)
        per_pos_area.append(m_area / (2 * (kmer_len - 1)))

    out = dict(
        ub_acc=(ub_matches / ub_len) if ub_len else np.nan,
        ub_matches=ub_matches, ub_len=ub_len,
        ub_area_acc=(ub_area_matches / ub_area_len) if ub_len else np.nan,
        ub_area_matches=ub_area_matches, ub_area_len=ub_area_len,
        non_ub_area_acc=(non_matches / non_len) if non_len else np.nan,
        fdr=fdr, fpr=fpr,
        true_pos=ub_matches,
        false_neg=ub_len - ub_matches,
        false_pos=false_ubs,
        true_neg=n - ub_len - false_ubs,
        ub_acc_per_pos=per_pos_ub,
        ub_area_acc_per_pos=per_pos_area,
        label_per_pos=x_positions,
    )
    return out


def levenshtein(a: str, b: str) -> int:
    """Edit distance (replaces the C Levenshtein dependency; a native
    version may back this transparently)."""
    if native.available():
        return native.levenshtein(a, b)
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def barcode_match(record: dict, read_seq: str, left_primer_len: int,
                  barcode: str, n_relax_bases: int = 3,
                  rc=None) -> dict:
    """Locate the barcode in the read and score it by edit distance
    (reference get_barcode_match_score, utils.py:1387-1434)."""
    if record["strand"] in ("+", "F"):
        read = read_seq
        read_start = record["read_start"]
    else:
        read = reverse_complement_str(read_seq)
        read_start = len(read) - record["read_end"]

    if left_primer_len >= record["target_start"]:
        start = left_primer_len - record["target_start"] + read_start
    else:
        start = max(read_start - (record["target_start"] - left_primer_len),
                    0)

    best = dict(barcode_distance=np.inf)
    L = len(barcode)
    for i in range(max(start - n_relax_bases, 0), start + n_relax_bases + 1):
        obs = read[i:i + L]
        d = levenshtein(barcode, obs)
        if d < best["barcode_distance"]:
            best = dict(
                barcode_detected=obs,
                barcode_detected_len=len(obs),
                barcode_start=i,
                barcode_end=i + L,
                barcode_distance=d,
            )
    return best
