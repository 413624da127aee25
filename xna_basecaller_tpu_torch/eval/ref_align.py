"""Copied from ``xna_basecaller_tpu/eval/ref_align.py``; only the package
imports differ, and ``align_fastq``'s worker pool starts its processes by
spawning (this package's callers hold threads and CUDA state, which a
forked child must not inherit).

Built-in read->template aligner producing PAF records with cs tags.

Replaces the minimap2 binary for the short-template eval pipeline
(reference eval_model.sh:128-132 runs ``minimap2 -x map-ont -w 5 -c
--cs=short --secondary=no refdb_short.fasta reads.fastq``): the templates
are ~106-160 bp, so full Smith-Waterman against every template is feasible
and exact.  When a real minimap2 binary is available it can be used
out-of-band as a verification oracle; this module keeps the pipeline
self-contained.

UB handling mirrors minimap2's view: templates encode UBs as 'N', and reads
containing X/Y are matched against 'N' positions the way the reference's
assertions expect (utils.py:172: called X/Y correspond to target N).
"""

from __future__ import annotations

from dataclasses import dataclass

from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
from xna_basecaller_tpu_torch.eval.accuracy import sw_align


def _cs_short(query: str, ref: str, cigar, q0: int, r0: int) -> str:
    """Build a minimap2-style short cs tag from the aligned region."""
    out = []
    qi, ri = q0, r0
    run = 0
    for op, count in cigar:
        if op == "=":
            run += count
            qi += count
            ri += count
            continue
        if run:
            out.append(f":{run}")
            run = 0
        if op == "X":
            for _ in range(count):
                out.append(f"*{ref[ri].lower()}{query[qi].lower()}")
                qi += 1
                ri += 1
        elif op == "I":
            out.append("+" + query[qi:qi + count].lower())
            qi += count
        elif op == "D":
            out.append("-" + ref[ri:ri + count].lower())
            ri += count
    if run:
        out.append(f":{run}")
    return "".join(out)


@dataclass
class PafRecord:
    read_id: str
    read_length: int
    read_start: int
    read_end: int
    strand: str
    target_id: str
    target_length: int
    target_start: int
    target_end: int
    n_matches: int
    alignment_block_length: int
    mapping_quality: int
    cs: str

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["target_cover"] = (self.target_end - self.target_start) \
            / self.target_length
        d["percent_match"] = self.n_matches / max(
            self.alignment_block_length, 1)
        return d


class SeedIndex:
    """Minimizer-free k-mer seed index over templates (both strands).

    The minimap2-lite prefilter that keeps full-SW alignment tractable for
    the 1024-template CPLX library: candidate (template, strand) pairs are
    ranked by exact seed-hit counts and only the top few are aligned.
    """

    def __init__(self, targets: dict[str, str], k: int = 12):
        self.k = k
        self.index: dict[str, list] = {}
        for tid, tar in targets.items():
            for strand, seq in (("+", tar),
                                ("-", reverse_complement_str(tar))):
                for i in range(len(seq) - k + 1):
                    km = seq[i:i + k]
                    if "N" not in km:
                        self.index.setdefault(km, []).append((tid, strand))

    def candidates(self, read_n: str, top: int = 5) -> list:
        counts: dict = {}
        k = self.k
        for i in range(len(read_n) - k + 1):
            for hit in self.index.get(read_n[i:i + k], ()):
                counts[hit] = counts.get(hit, 0) + 1
        return sorted(counts, key=counts.get, reverse=True)[:top]


def align_read(read_id: str, seq: str, targets: dict[str, str],
               min_score: int = 30,
               seed_index: SeedIndex | None = None,
               top_candidates: int = 5,
               rescue_frac: float = 0.45) -> PafRecord | None:
    """Best local alignment of a read against the templates, both strands.

    For UB-aware alignment the read's X/Y are scored as 'N' matches the
    dnafull way (N scores -2 vs everything) by mapping X/Y -> N before SW;
    the cs tag is then built against the N-encoded template, like
    minimap2's view of the reference fasta.

    With a ``seed_index`` only the top seed-hit candidates are SW-aligned.
    On noisy reads exact 12-mer seeds can all miss (or rank a wrong
    template first), so the seed path is cross-checked: when the best
    candidate alignment scores below ``rescue_frac`` of the perfect-match
    score for its template, the full exhaustive scan re-runs and wins if
    it finds anything better — the seed index is then purely an
    accelerator, never a silent accuracy loss.
    """
    seq_n = seq.replace("X", "N").replace("Y", "N")
    rc_n = reverse_complement_str(seq_n)

    def _scan(pairs):
        # score-only batched native pass first: one ctypes call for all
        # (strand, template) pairs, then a single traceback alignment of
        # the winner.  Falls back to per-pair sw_align without the
        # native library (same scores — sw_score_batch shares the DP).
        if len(pairs) > 8:
            import numpy as np

            from xna_basecaller_tpu_torch.utils.native import sw_score_batch
            by_q: dict[str, list[int]] = {}
            for i, (_, s, _) in enumerate(pairs):
                by_q.setdefault(s, []).append(i)
            scores = np.zeros(len(pairs), np.int64)
            for s, idxs in by_q.items():
                batch = sw_score_batch(
                    s, [targets[pairs[i][2]] for i in idxs])
                if batch is None:
                    scores = None
                    break
                scores[idxs] = batch
            if scores is not None:
                bi = int(np.argmax(scores))
                if scores[bi] < min_score:
                    return None
                strand, s, tid = pairs[bi]
                score, cigar, (q0, q1, r0, r1) = sw_align(s, targets[tid])
                if not cigar or score < min_score:
                    return None
                return (score, strand, tid, s, cigar, q0, q1, r0, r1)
        best = None
        for strand, s, tid in pairs:
            tar = targets[tid]
            score, cigar, (q0, q1, r0, r1) = sw_align(s, tar)
            if not cigar or score < min_score:
                continue
            if best is None or score > best[0]:
                best = (score, strand, tid, s, cigar, q0, q1, r0, r1)
        return best

    full_pairs = [(strand, s, tid)
                  for strand, s in (("+", seq_n), ("-", rc_n))
                  for tid in targets]
    best = None
    if seed_index is not None:
        cands = seed_index.candidates(seq_n, top=top_candidates)
        best = _scan([(strand, seq_n if strand == "+" else rc_n, tid)
                      for tid, strand in cands])
        # rescue: perfect match scores ~5 per aligned base over the
        # template span; a weak seed-path best may be a wrong template
        if best is not None:
            perfect = 5 * min(len(seq_n), len(targets[best[2]]))
            if best[0] >= rescue_frac * perfect:
                full_pairs = None  # seed result is trusted
    if full_pairs is not None:
        full_best = _scan(full_pairs)
        if full_best is not None and (
                best is None or full_best[0] > best[0]):
            best = full_best
    if best is None:
        return None
    score, strand, tid, s, cigar, q0, q1, r0, r1 = best
    tar = targets[tid]
    n_match = sum(c for op, c in cigar if op == "=")
    block = sum(c for _, c in cigar)
    if strand == "-":
        # read coords reported on the original (forward) read
        read_start = len(seq) - q1
        read_end = len(seq) - q0
    else:
        read_start, read_end = q0, q1
    return PafRecord(
        read_id=read_id, read_length=len(seq),
        read_start=read_start, read_end=read_end, strand=strand,
        target_id=tid, target_length=len(tar),
        target_start=r0, target_end=r1,
        n_matches=n_match, alignment_block_length=block,
        mapping_quality=60,
        cs=_cs_short(s, tar, cigar, q0, r0),
    )


def align_fastq(reads: dict[str, str], targets: dict[str, str],
                min_score: int = 30, n_proc: int = 0,
                use_seeds: bool | None = None) -> list[dict]:
    """Align many reads; returns PAF records as dicts (paf_df rows).

    Seed prefiltering is on by default for libraries with many templates
    (the CPLX/1024 case); small libraries do the exhaustive scan.
    """
    if use_seeds is None:
        use_seeds = len(targets) > 64
    seed_index = SeedIndex(targets) if use_seeds else None
    if n_proc and n_proc > 1:
        import multiprocessing
        from functools import partial
        with multiprocessing.get_context("spawn").Pool(n_proc) as pool:
            recs = pool.starmap(
                partial(align_read, targets=targets, min_score=min_score,
                        seed_index=seed_index),
                reads.items(), chunksize=16)
    else:
        recs = [align_read(rid, seq, targets, min_score,
                           seed_index=seed_index)
                for rid, seq in reads.items()]
    return [r.as_dict() for r in recs if r is not None]


def write_paf(records: list[dict], path: str) -> None:
    """Write minimap2-compatible PAF lines (+cs tag).  Atomic: PAF
    presence is a resume marker in the eval chains."""
    from xna_basecaller_tpu_torch.utils.fileio import atomic_output
    with atomic_output(path) as fh:
        for r in records:
            fh.write("\t".join(str(x) for x in (
                r["read_id"], r["read_length"], r["read_start"],
                r["read_end"], r["strand"], r["target_id"],
                r["target_length"], r["target_start"], r["target_end"],
                r["n_matches"], r["alignment_block_length"],
                r["mapping_quality"], f"cs:Z:{r['cs']}")) + "\n")


def read_paf(path: str) -> list[dict]:
    """Parse PAF (+cs tag) lines back into record dicts (reference
    src/misc/data_io.py:77-138)."""
    out = []
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            rec = dict(
                read_id=f[0], read_length=int(f[1]), read_start=int(f[2]),
                read_end=int(f[3]), strand=f[4], target_id=f[5],
                target_length=int(f[6]), target_start=int(f[7]),
                target_end=int(f[8]), n_matches=int(f[9]),
                alignment_block_length=int(f[10]),
                mapping_quality=int(f[11]), cs="")
            for tag in f[12:]:
                if tag.startswith("cs:Z:"):
                    rec["cs"] = tag[5:]
            rec["target_cover"] = (rec["target_end"] - rec["target_start"]) \
                / rec["target_length"]
            rec["percent_match"] = rec["n_matches"] / max(
                rec["alignment_block_length"], 1)
            out.append(rec)
    return out
