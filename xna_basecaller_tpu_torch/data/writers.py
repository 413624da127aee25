"""Copied from ``xna_basecaller_tpu/data/writers.py``: the FASTQ writer
and readers, the phred helpers and the per-read summary row.

SAM/BAM output and the CTC training-data writer are not ported yet, so
their parts of the source (``sam_record_fields``, ``SamWriter``,
``typical_indices``, ``CtcDataWriter``) are left out.
"""

from __future__ import annotations

import numpy as np


def phred(prob: float, scale: float = 1.0, bias: float = 0.0) -> str:
    """Probability -> ascii phred char (reference util.py:115-121)."""
    p = max(1 - prob, 1e-4)
    q = -10 * np.log10(p) * scale + bias
    return chr(int(np.round(q) + 33))


def mean_qscore_from_qstring(qstring: str) -> float:
    """Mean qscore of an ascii qstring (reference util.py:124-131)."""
    if len(qstring) == 0:
        return 0.0
    qs = np.frombuffer(qstring.encode(), np.uint8) - 33
    mean_err = np.exp(qs * (-np.log(10) / 10.0)).mean()
    return -10 * np.log10(max(mean_err, 1e-4))


def write_fastq(fd, read_id: str, seq: str, qstring: str,
                tags: list[str] | None = None) -> None:
    header = "@" + read_id
    if tags:
        header += "\t" + "\t".join(tags)
    fd.write(f"{header}\n{seq}\n+\n{qstring}\n")


def read_fastq(path: str) -> dict[str, str]:
    """read_id -> sequence."""
    out = {}
    with open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                break
            seq = fh.readline().strip()
            fh.readline()
            fh.readline()
            out[h[1:].split()[0].strip()] = seq
    return out


def read_fastq_quals(path: str) -> dict[str, np.ndarray]:
    """read_id -> phred quality array (reference data_io.get_read_qual)."""
    out = {}
    with open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                break
            fh.readline()
            fh.readline()
            qual = fh.readline().strip()
            out[h[1:].split()[0].strip()] = (
                np.frombuffer(qual.encode(), np.uint8).astype(np.int32) - 33)
    return out


def read_fastq_seqs_quals(path: str) -> dict[str, tuple[str, str]]:
    """read_id -> (sequence, quality string)."""
    out = {}
    with open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                break
            seq = fh.readline().strip()
            fh.readline()
            qual = fh.readline().strip()
            out[h[1:].split()[0].strip()] = (seq, qual)
    return out


def summary_row(read, seqlen: int, mean_qscore: float,
                alignment: dict | None = None) -> dict:
    """Per-read summary.tsv row (reference io.py:158-237, abridged to the
    columns the eval pipeline consumes)."""
    row = {
        "filename": getattr(read, "filename", ""),
        "read_id": read.read_id,
        "run_id": getattr(read, "run_id", ""),
        "channel": getattr(read, "channel", 0),
        "mux": getattr(read, "mux", 0),
        "start_time": getattr(read, "start", 0.0),
        "duration": getattr(read, "duration", 0.0),
        "template_start": getattr(read, "template_start", 0.0),
        "template_duration": getattr(read, "template_duration", 0.0),
        "sequence_length_template": seqlen,
        "mean_qscore_template": mean_qscore,
    }
    # fixed schema: unmapped reads get '*'/0 defaults so every row has
    # the same columns (the reference's Writer does the same,
    # io.py:190-237; ragged TSVs break pandas consumers like the duplex
    # pair finder)
    a = alignment or {}
    row.update({
        "alignment_genome": a.get("target_id", "*"),
        "alignment_genome_start": a.get("target_start", 0),
        "alignment_genome_end": a.get("target_end", 0),
        "alignment_strand_start": a.get("read_start", 0),
        "alignment_strand_end": a.get("read_end", 0),
        "alignment_direction": a.get("strand", "*"),
        "alignment_length": a.get("alignment_block_length", 0),
        "alignment_num_correct": a.get("n_matches", 0),
        "alignment_identity": a.get("percent_match", 0.0),
        "alignment_coverage": a.get("target_cover", 0.0),
    })
    return row
