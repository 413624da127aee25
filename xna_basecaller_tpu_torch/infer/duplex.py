"""Port of ``xna_basecaller_tpu/infer/duplex.py``: ``duplex_consensus``
and ``DuplexRead`` are copies; ``duplex_pairs`` basecalls on the model's
device (with ``qscores``: K2a and the q-score K2b and K2c on the card) and,
with ``pair_decode``, runs ``infer/pair_decode.py``; ``find_follow_on``
takes the summary's columns as ``read_summary`` reads them with the
``csv`` module (JAX's takes a pandas DataFrame, which the card's machine
cannot make).

Duplex (template/complement) consensus calling.

The reference's duplex pipeline (ub-bonito/bonito/cli/duplex.py) is broken
in its own release — line 37 imports symbols removed from crf.basecall —
and its decoder (`crf_beam_search_duplex`) only exists for the 4-base
alphabet, so it cannot run the 6-base XNA models at all.  This module is a
working redesign on the same inputs/outputs:

- ``find_follow_on``: the reference's pair finder semantics
  (duplex.py:184-214) over our sequencing summary — same channel+mux,
  opposite alignment directions, adjacent in time, near-identical genome
  coordinates.
- ``duplex_consensus``: instead of a CUDA pair beam-search, the template
  basecall and the reverse-complemented complement basecall are aligned
  (native Smith-Waterman) and merged base-by-base with quality
  arithmetic: agreements sum phreds (independent evidence), conflicts
  keep the higher-quality base with the phred difference, single-strand
  indels survive only above a quality floor.  This supports the full
  6-letter XNA alphabet.
- ``duplex_pairs``: basecall both strands (with real qscores) and emit
  consensus reads.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
from xna_basecaller_tpu_torch.utils import native

Q_CAP = 60  # phred ceiling for summed evidence


def _col(summary, name: str) -> np.ndarray:
    return np.asarray(list(summary[name]))


def find_follow_on(summary, gap: float = 5.0, distance: int = 51,
                   cov: float = 0.85, min_len: int = 100) -> list[tuple]:
    """Find (template_id, complement_id) follow-on pairs in a sequencing
    summary (reference duplex.py:184-214 semantics).

    ``summary`` maps each column name to its values (e.g. ``read_summary``
    of a summary TSV: strings, as the ``csv`` module reads them).  JAX's
    takes a pandas DataFrame; the rows are kept, sorted (by run_id, then
    channel, mux and start_time as numbers; a stable sort, as pandas'
    sort on several columns) and compared in the same way.

    Consecutive reads on the same channel+mux whose alignments land on
    near-identical genome coordinates in opposite directions, with less
    than ``gap`` seconds between them.
    """
    keep = ((_col(summary, "alignment_coverage").astype(np.float64)
             .astype(np.float32) > cov)
            & (_col(summary, "sequence_length_template").astype(np.int32)
               > min_len))
    rows = np.flatnonzero(keep)
    if len(rows) < 2:
        return []

    def col(name, dtype=None):
        # numbers parsed as f64 first, as pandas reads them
        v = _col(summary, name)[rows]
        if dtype is None:
            return v
        return v.astype(np.float64 if dtype == np.float32 else dtype
                        ).astype(dtype)

    order = np.lexsort((col("start_time", np.float64), col("mux", np.int64),
                        col("channel", np.int64),
                        col("run_id").astype(str)))
    rows = rows[order]
    g_start = col("alignment_genome_start", np.int32)
    g_end = col("alignment_genome_end", np.int32)
    direction = col("alignment_direction").astype(str)
    t_start = col("start_time", np.float32)
    t_end = t_start + col("duration", np.float32)
    channel = col("channel", np.int32)
    mux = col("mux", np.int32)
    follow = ((channel[1:] == channel[:-1])
              & (mux[1:] == mux[:-1])
              & (np.abs(g_start[1:] - g_start[:-1]) < distance)
              & (np.abs(g_end[1:] - g_end[:-1]) < distance)
              & (direction[1:] != direction[:-1])
              & (t_start[1:] - t_end[:-1] < gap))
    ids = col("read_id").astype(str)
    return [(ids[i], ids[i + 1]) for i in np.flatnonzero(follow)]


def read_summary(path: str) -> dict[str, list[str]]:
    """A summary TSV's columns, values as strings (no pandas)."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh, delimiter="\t"))
    names = list(rows[0]) if rows else []
    return {k: [r[k] for r in rows] for k in names}


def _q(ch: str) -> int:
    return ord(ch) - 33


def _qch(q: int) -> str:
    return chr(min(max(int(q), 1), Q_CAP) + 33)


def duplex_consensus(seq1: str, q1: str, seq2: str, q2: str,
                     min_indel_q: int = 15) -> tuple[str, str]:
    """Merge a template basecall with its complement-strand basecall.

    seq2/q2 are the complement read AS CALLED (its own 5'->3' direction);
    it is reverse-complemented here.  Returns (sequence, qstring) on the
    template strand.  Falls back to the higher-mean-quality single strand
    when the two calls don't align.
    """
    rc2 = reverse_complement_str(seq2)
    rq2 = q2[::-1]
    if not seq1 or not rc2:
        return (seq1, q1) if seq1 else (rc2, rq2)
    score, cigar, (a0, a1, b0, b1) = native.sw_align(seq1, rc2)
    if score <= 0:
        from xna_basecaller_tpu_torch.data.writers import (
            mean_qscore_from_qstring,
        )
        return ((seq1, q1)
                if mean_qscore_from_qstring(q1)
                >= mean_qscore_from_qstring(rq2) else (rc2, rq2))
    out_s, out_q = [], []
    # unaligned template flanks survive as simplex (complement flanks are
    # usually adapter/primer tails on the other strand — dropped)
    out_s.append(seq1[:a0])
    out_q.append(q1[:a0])
    i, j = a0, b0
    for op, n in cigar:
        for _ in range(n):
            if op == "=":
                out_s.append(seq1[i])
                out_q.append(_qch(_q(q1[i]) + _q(rq2[j])))
                i += 1
                j += 1
            elif op == "X":
                if _q(q1[i]) >= _q(rq2[j]):
                    out_s.append(seq1[i])
                    out_q.append(_qch(_q(q1[i]) - _q(rq2[j])))
                else:
                    out_s.append(rc2[j])
                    out_q.append(_qch(_q(rq2[j]) - _q(q1[i])))
                i += 1
                j += 1
            elif op == "I":  # base only in the template call
                if _q(q1[i]) >= min_indel_q:
                    out_s.append(seq1[i])
                    out_q.append(q1[i])
                i += 1
            else:  # "D": base only in the complement call
                if _q(rq2[j]) >= min_indel_q:
                    out_s.append(rc2[j])
                    out_q.append(rq2[j])
                j += 1
    out_s.append(seq1[a1:])
    out_q.append(q1[a1:])
    return "".join(out_s), "".join(out_q)


@dataclass
class DuplexRead:
    read_id: str
    sequence: str
    qstring: str
    template_id: str
    complement_id: str


def duplex_pairs(model, pairs: list[tuple], reads: Iterable,
                 chunksize: int = 3600, overlap: int = 500,
                 batchsize: int = 256, min_indel_q: int = 15,
                 pair_decode: bool = False,
                 padding: int = 40) -> Iterator[DuplexRead]:
    """Basecall every read involved in ``pairs`` (with real qscores) and
    yield duplex consensus reads (template read id + ';duplex').

    ``pair_decode=True`` runs the envelope-constrained exact pair
    Viterbi over both strands' transition posteriors
    (infer/pair_decode.py — the reference duplex.py:257-297 algorithm,
    full XNA alphabet) and falls back to the quality-arithmetic
    consensus merge when the pair fails its simplex match gate or the
    DP is infeasible."""
    from xna_basecaller_tpu_torch.infer.basecall import basecall

    wanted = {r for pair in pairs for r in pair}
    calls: dict[str, tuple[str, str]] = {}
    signals: dict[str, np.ndarray] = {}
    keep_signals = pair_decode

    def _tap(rs):
        for r in rs:
            if r.read_id in wanted:
                if keep_signals:
                    signals[r.read_id] = np.asarray(r.signal, np.float32)
                yield r

    for read, attrs in basecall(
            model, _tap(reads),
            chunksize=chunksize, overlap=overlap, batchsize=batchsize,
            qscores=True):
        calls[read.read_id] = (attrs["sequence"], attrs["qstring"])
    alphabet = None
    if pair_decode:
        alphabet = model.seqdist.alphabet
        if not isinstance(alphabet, str):
            alphabet = "".join(alphabet)
    for tid, cid in pairs:
        if tid not in calls or cid not in calls:
            continue
        if pair_decode and tid in signals and cid in signals:
            from xna_basecaller_tpu_torch.infer import pair_decode as pdec
            t1, i1 = pdec.read_transition_probs(
                model, signals[tid], chunksize, overlap)
            t2, i2 = pdec.read_transition_probs(
                model, signals[cid], chunksize, overlap, reverse=True)
            got = pdec.decode_pair(t1, i1, t2, i2, alphabet,
                                   padding=padding)
            if got is not None:
                yield DuplexRead(f"{tid};duplex", got[0], got[1], tid, cid)
                continue
        seq1, q1 = calls[tid]
        seq2, q2 = calls[cid]
        seq, q = duplex_consensus(seq1, q1, seq2, q2,
                                  min_indel_q=min_indel_q)
        if seq:
            yield DuplexRead(f"{tid};duplex", seq, q, tid, cid)
