"""Copied from ``xna_basecaller_tpu/data/writers.py``; only the package
imports differ, and ``qstring`` (the q-string of a read's bases as one
numpy pass, equal to JAX's loop over ``phred``) is the port's own.

Output writers: FASTQ/SAM, per-read summary, and CTC training data.

Re-implements the reference's writer stack without pysam (reference:
ub-bonito/bonito/io.py): text FASTQ/SAM with read-group tags, the
``summary.tsv`` per-read log, and the CTCWriter that builds new ctc-data
(.npy) from aligned basecalls with accuracy/coverage gates, strand-aware
N -> 5/6 target encoding (io.py:536-540) and the +-2.5 sigma typical-length
filter + shuffle (io.py:562-579).
"""

from __future__ import annotations

import os

import numpy as np

from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
from xna_basecaller_tpu_torch.data.ctc_data import atomic_np_save
from xna_basecaller_tpu_torch.eval.cs_align import parse_cs


def phred(prob: float, scale: float = 1.0, bias: float = 0.0) -> str:
    """Probability -> ascii phred char (reference util.py:115-121)."""
    p = max(1 - prob, 1e-4)
    q = -10 * np.log10(p) * scale + bias
    return chr(int(np.round(q) + 33))


def qstring(probs: np.ndarray, scale: float = 1.0, bias: float = 0.0):
    """The quality string of per-base probabilities, equal to joining
    ``phred`` of each (as ``infer/basecall.py:339-347`` of the JAX package
    builds it), in one pass of numpy: 1 - p in f32, the f32 chain
    -10 log10(1 - p) * scale + bias where 1 - p > 1e-4 (numpy's scalar
    promotion keeps f32 there), the f64 chain at 1e-4 where it clamps,
    rounded half to even, + 33, each a character."""
    p = np.float32(1) - np.asarray(probs, np.float32)
    clamp = np.float32(1e-4) > p   # max(1 - p, 1e-4) takes 1e-4
    q = -10 * np.log10(np.where(clamp, np.float32(1), p)) * scale + bias
    q_clamped = -10 * np.log10(1e-4) * scale + bias
    codes = np.where(clamp, np.round(q_clamped) + 33,
                     np.round(q) + 33).astype(np.int64)
    if codes.size and (codes.min() < 0 or codes.max() > 0x10FFFF):
        raise ValueError("chr() arg not in range(0x110000)")
    return codes.astype("<u4").tobytes().decode("utf-32-le")


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


def _cigar_from_cs(cs: str) -> str:
    parts = []

    def push(op, n):
        if parts and parts[-1][0] == op:
            parts[-1][1] += n
        else:
            parts.append([op, n])

    for op in parse_cs(cs):
        sym, val = op[0], op[1:]
        if sym == ":":
            push("M", int(val))
        elif sym == "=":
            push("M", len(val))
        elif sym == "*":
            push("M", 1)
        elif sym == "+":
            push("I", len(val))
        elif sym == "-":
            push("D", len(val))
    return "".join(f"{n}{op}" for op, n in parts)


def sam_record_fields(read_id: str, seq: str, qstring: str,
                      mapping: dict | None = None) -> list[str]:
    """The 11 mandatory SAM fields for one basecalled read.

    Shared between the text SamWriter and the binary BamWriter
    (reference io.py:379-445 builds the same record via pysam)."""
    if mapping is None:
        return [read_id, "4", "*", "0", "0", "*", "*", "0", "0",
                seq, qstring or "*"]
    flag = "16" if mapping["strand"] in ("-", "R") else "0"
    out_seq = seq
    out_q = qstring
    if flag == "16":
        out_seq = reverse_complement_str(seq)
        out_q = qstring[::-1]
    clip_l = mapping["read_start"]
    clip_r = mapping["read_length"] - mapping["read_end"]
    if flag == "16":
        clip_l, clip_r = clip_r, clip_l
    cig = _cigar_from_cs(mapping["cs"])
    if clip_l:
        cig = f"{clip_l}S" + cig
    if clip_r:
        cig = cig + f"{clip_r}S"
    return [read_id, flag, mapping["target_id"],
            str(mapping["target_start"] + 1),
            str(mapping.get("mapping_quality", 60)), cig, "*",
            "0", "0", out_seq, out_q or "*"]


class SamWriter:
    """Minimal text SAM writer (reference io.py:379-445 without pysam).

    ``read_group`` emits an @RG header (reference io.py:86-111 builds it
    as ``<run_id>_<model>``) and stamps every record with RG:Z."""

    def __init__(self, fd, targets: dict[str, str] | None = None,
                 program: str = "xnacall", read_group: str | None = None):
        self.fd = fd
        self.read_group = read_group
        fd.write("@HD\tVN:1.5\tSO:unknown\n")
        if targets:
            for name, seq in targets.items():
                fd.write(f"@SQ\tSN:{name}\tLN:{len(seq)}\n")
        if read_group:
            fd.write(f"@RG\tID:{read_group}\tPL:ONT\n")
        fd.write(f"@PG\tID:basecaller\tPN:{program}\n")

    def write(self, read_id: str, seq: str, qstring: str,
              mapping: dict | None = None, tags: list[str] | None = None):
        fields = sam_record_fields(read_id, seq, qstring, mapping)
        if self.read_group:
            fields.append(f"RG:Z:{self.read_group}")
        if tags:
            fields += tags
        self.fd.write("\t".join(fields) + "\n")


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


def typical_indices(x, n: float = 2.5) -> np.ndarray:
    """Indices within n sigma of the mean (reference convert.py:80-83).

    With zero spread every index is typical (the reference's strict
    inequalities would discard everything — a latent edge case)."""
    x = np.asarray(x)
    mu, sd = np.mean(x), np.std(x)
    if sd == 0:
        return np.arange(len(x))
    idx, = np.where((mu - n * sd < x) & (x < mu + n * sd))
    return idx


class CtcDataWriter:
    """Accumulates aligned chunk basecalls into ctc-data .npy files
    (reference CTCWriter, io.py:448-588)."""

    def __init__(self, output_directory: str, min_coverage: float = 0.90,
                 min_accuracy: float = 0.95, ub_only: bool = False,
                 seed: int = 25, log=print):
        self.dir = output_directory
        self.min_coverage = min_coverage
        self.min_accuracy = min_accuracy
        self.ub_only = ub_only
        self.rng = np.random.default_rng(seed)
        self.log = log
        self.chunks: list[np.ndarray] = []
        self.targets: list[list[int]] = []
        self.stats = dict(count_failed_seq=0, count_failed_map=0,
                          count_failed_acc=0, count_failed_cov=0,
                          count_failed_both=0, non_ubs_skipped=0)

    def add(self, signal: np.ndarray, seq: str,
            mapping: dict | None, refseq: str | None = None):
        """One chunk-read; ``refseq`` is the aligned reference span
        (template coordinates, with UBs as 'N')."""
        if len(seq) == 0:
            self.stats["count_failed_seq"] += 1
            return False
        if mapping is None:
            self.stats["count_failed_map"] += 1
            return False
        cov = (mapping["read_end"] - mapping["read_start"]) / len(seq)
        acc = mapping["n_matches"] / max(mapping["alignment_block_length"], 1)
        if refseq is None:
            refseq = mapping["refseq"]
        if self.ub_only and "N" not in refseq:
            self.stats["non_ubs_skipped"] += 1
            return False
        bad_acc = acc < self.min_accuracy
        bad_cov = cov < self.min_coverage
        self.stats["count_failed_acc"] += bad_acc
        self.stats["count_failed_cov"] += bad_cov
        self.stats["count_failed_both"] += bad_acc and bad_cov
        if bad_acc or bad_cov:
            return False
        if mapping["strand"] in ("-", "R"):
            refseq = reverse_complement_str(refseq)
        # strand-aware UB encoding: N -> 5 (X) on forward, 6 (Y) on reverse
        ub_code = "5" if mapping["strand"] in ("+", "F") else "6"
        table = str.maketrans({"A": "1", "C": "2", "G": "3", "T": "4",
                               "N": ub_code})
        target = [int(c) for c in refseq.translate(table)]
        self.targets.append(target)
        self.chunks.append(np.asarray(signal, np.float16))
        return True

    def save(self) -> int:
        if not self.chunks:
            self.log("> no suitable ctc data to write")
            return 0
        os.makedirs(self.dir, exist_ok=True)
        chunks = np.stack(self.chunks)
        lengths = np.array([len(t) for t in self.targets], np.uint16)
        targets = np.zeros((len(chunks), int(lengths.max())), np.uint8)
        for i, t in enumerate(self.targets):
            targets[i, : len(t)] = t
        indices = self.rng.permutation(typical_indices(lengths))
        # chunks.npy is the shard's resume/skip marker: write it last and
        # atomically so a kill mid-save can't leave a half-complete shard
        atomic_np_save(os.path.join(self.dir, "references.npy"),
                       targets[indices])
        atomic_np_save(os.path.join(self.dir, "reference_lengths.npy"),
                       lengths[indices])
        with open(os.path.join(self.dir, "filter_stats.csv"), "w") as fh:
            fh.write(",0\n")
            for k, v in self.stats.items():
                fh.write(f"{k},{int(v)}\n")
        atomic_np_save(os.path.join(self.dir, "chunks.npy"),
                       chunks[indices])
        self.log(f"> written ctc training data: {len(indices)} chunks")
        return len(indices)
