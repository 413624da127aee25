"""Copied from ``xna_basecaller_tpu/eval/construct_align.py``.

Aligner for full-length library-construct references.

Real library molecules are ~2.7 kb vector constructs sharing one backbone,
with a short per-template insert (reference xna_libs/CPLX/refdb.fasta:
1024 records, identical outside the insert; the reference's CTC-data
builder aligns chunk basecalls against this full refdb with minimap2 so
every kept chunk gets a target covering essentially all of its signal —
io.py:469-505, cov = aligned/len(seq) >= 0.90).

Aligning a ~360 bp chunk basecall against 1024 near-identical 2.7 kb
records with plain SW is wasteful and, via a k-mer seed index, degenerate
(backbone seeds hit every record equally).  This module exploits the
shared-backbone structure instead:

1. locate: Smith-Waterman against ONE canonical construct (both strands);
2. demux:  if the aligned span overlaps the insert, map the insert window
   back to read coordinates through the cigar and pick the template with
   the smallest edit distance over that window (the reference's
   barcode-demux idea, utils.py:1387-1434, applied at data-build time);
3. refine: re-run SW against the chosen template's construct for the
   exact final mapping (coords differ when insert lengths differ).

Backbone-only chunks skip steps 2-3: the mapping is template-independent.
"""

from __future__ import annotations

from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
from xna_basecaller_tpu_torch.eval.accuracy import sw_align
from xna_basecaller_tpu_torch.eval.ref_align import PafRecord, _cs_short
from xna_basecaller_tpu_torch.eval.cs_align import levenshtein
from xna_basecaller_tpu_torch.utils.native import lev_demux, sw_align_banded


class DiagIndex:
    """k-mer -> diagonal voting over one reference sequence.

    Locates a read's diagonal (ref_pos - query_pos) before alignment so
    the DP can run banded (native sw_align_banded) instead of the full
    nq*nr matrix — the locate-then-extend shape minimap2 uses.  Buckets
    diagonals by ``bucket`` to tolerate indels between seeds.
    """

    def __init__(self, ref: str, k: int = 13, bucket: int = 16):
        self.k = k
        self.bucket = bucket
        idx: dict[str, list[int]] = {}
        for i in range(len(ref) - k + 1):
            idx.setdefault(ref[i:i + k], []).append(i)
        self.idx = idx

    def best_diag(self, q: str, stride: int = 2) -> tuple[int, int]:
        """(center diagonal, votes); votes == 0 when nothing seeds."""
        votes: dict[int, int] = {}
        k, b = self.k, self.bucket
        get = self.idx.get
        for i in range(0, len(q) - k + 1, stride):
            for rpos in get(q[i:i + k], ()):
                d = (rpos - i) // b
                votes[d] = votes.get(d, 0) + 1
        if not votes:
            return 0, 0
        best = max(votes, key=lambda d: votes[d] + votes.get(d - 1, 0)
                   + votes.get(d + 1, 0))
        n = votes[best] + votes.get(best - 1, 0) + votes.get(best + 1, 0)
        return best * b + b // 2, n


def query_span_for_ref_window(cigar, q0: int, r0: int,
                              wlo: int, whi: int) -> tuple[int, int] | None:
    """Read-coordinate span aligned to reference window [wlo, whi).

    Walks the SW cigar (ops "=", "X", "I", "D"); returns None when the
    window lies outside the aligned reference span.
    """
    qi, ri = q0, r0
    qlo = qhi = None
    for op, n in cigar:
        if op in ("=", "X"):
            if qlo is None and ri <= wlo < ri + n:
                qlo = qi + (wlo - ri)
            if ri < whi <= ri + n:
                qhi = qi + (whi - ri)
            qi += n
            ri += n
        elif op == "I":
            qi += n
        elif op == "D":
            if qlo is None and ri <= wlo < ri + n:
                qlo = qi
            if ri < whi <= ri + n:
                qhi = qi
            ri += n
    if qlo is None and qhi is not None:
        qlo = q0  # window started before the alignment
    if qhi is None and qlo is not None:
        qhi = qi  # window ended after the alignment
    if qlo is None or qhi is None or qhi < qlo:
        return None
    return qlo, qhi


class ConstructAligner:
    """Two-stage chunk-basecall -> full-construct aligner (see module doc).

    ``full_targets`` values are 'N'-encoded constructs (XnaRefs.full_targets);
    reads may contain X/Y, which are normalised to N before scoring, the
    minimap2 view the downstream machinery expects (ref_align.py docstring).
    """

    def __init__(self, full_targets: dict[str, str], insert_lo: int,
                 right_flank_len: int, min_score: int = 30,
                 demux_pad: int = 6):
        self.targets = full_targets
        self.ids = list(full_targets)
        self.canon_id = self.ids[0]
        self.canon = full_targets[self.canon_id]
        self.insert_lo = insert_lo
        self.right_flank_len = right_flank_len
        self.min_score = min_score
        self.demux_pad = demux_pad
        # per-template insert window [lo, hi) in that template's coords
        self.insert_hi = {tid: len(t) - right_flank_len
                          for tid, t in full_targets.items()}
        # distinct insert sequences -> representative tids (CPLX: all 1024
        # distinct; merged libraries may alias PC duplicates)
        self._inserts = {tid: t[insert_lo:self.insert_hi[tid]]
                         for tid, t in full_targets.items()}
        self._diag = DiagIndex(self.canon)

    def _sw(self, s: str, tid: str, diag: tuple[int, int] | None = None):
        """Seed-located banded SW with full-matrix rescue.

        The diagonal comes from seeding against the CANONICAL construct —
        valid for every template because the backbone is shared and
        insert-length deltas are absorbed by the band pad.  A banded
        result is trusted only if it aligns most of the read at a healthy
        per-base score; otherwise (seed miss, band exit, junk read) the
        exact full matrix re-runs, so banding is purely an accelerator.
        """
        d, votes = diag if diag is not None else self._diag.best_diag(s)
        if votes >= 4:
            pad = 48 + len(s) // 6
            res = sw_align_banded(s, self.targets[tid], d - pad, d + pad)
            if res is not None:
                score, cigar, (q0, q1, r0, r1) = res
                if (cigar and q1 - q0 >= 0.6 * len(s)
                        and score >= 2.5 * (q1 - q0)):
                    return res
        return sw_align(s, self.targets[tid])

    def align(self, read_id: str, seq: str) -> PafRecord | None:
        seq_n = seq.replace("X", "N").replace("Y", "N")
        rc_n = reverse_complement_str(seq_n)

        pairs = []
        for strand, s in (("+", seq_n), ("-", rc_n)):
            pairs.append((strand, s, self._diag.best_diag(s)))
        vmax = max(p[2][1] for p in pairs)

        best = None
        best_diag = None
        for strand, s, diag in pairs:
            if vmax >= 4 and diag[1] < 4:
                # the other strand seeds well and this one not at all: a
                # 360bp alignment without a single 13-mer seed cannot
                # outscore the seeded strand — skip its full-matrix scan
                continue
            score, cigar, (q0, q1, r0, r1) = self._sw(
                s, self.canon_id, diag)
            if cigar and score >= self.min_score and (
                    best is None or score > best[0]):
                best = (score, strand, s, cigar, q0, q1, r0, r1)
                best_diag = diag
        if best is None:
            return None
        score, strand, s, cigar, q0, q1, r0, r1 = best

        tid = self.canon_id
        lo = self.insert_lo
        hi = self.insert_hi[self.canon_id]
        if r1 > lo and r0 < hi:  # overlaps the insert -> demux
            wlo = max(lo - self.demux_pad, r0)
            whi = min(hi + self.demux_pad, r1)
            span = query_span_for_ref_window(cigar, q0, r0, wlo, whi)
            if span is not None and span[1] > span[0]:
                window = s[span[0]:span[1]]
                # compare against the matching slice of each candidate
                # insert (clip to the part of the insert the read covers)
                off_lo = wlo - lo
                off_hi = whi - lo  # may exceed a shorter insert; clip below
                wins = []
                for cand in self.ids:
                    ins = self._inserts[cand]
                    wins.append(self.targets[cand][wlo:whi]
                                if off_lo < 0 or off_hi > len(ins)
                                else ins[max(off_lo, 0):off_hi])
                batched = lev_demux(window, wins)
                if batched is not None:
                    tid = self.ids[batched[0]]
                else:  # no native library: per-candidate python loop
                    tid = self.ids[min(
                        range(len(wins)),
                        key=lambda c: levenshtein(window, wins[c]))]
            if tid != self.canon_id:
                score2, cigar2, (q0b, q1b, r0b, r1b) = self._sw(
                    s, tid, best_diag)
                if cigar2 and score2 >= self.min_score:
                    score, cigar = score2, cigar2
                    q0, q1, r0, r1 = q0b, q1b, r0b, r1b
                else:
                    tid = self.canon_id

        tar = self.targets[tid]
        n_match = sum(c for op, c in cigar if op == "=")
        block = sum(c for _, c in cigar)
        if strand == "-":
            read_start, read_end = len(seq) - q1, len(seq) - q0
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

    def refseq(self, rec: PafRecord) -> str:
        """'N'-encoded reference span of a mapping (CTC-data target)."""
        return self.targets[rec.target_id][rec.target_start:rec.target_end]


def from_refs(refs, with_ubs: bool = True, min_score: int = 30,
              xna_only: bool = True) -> ConstructAligner:
    """Build a ConstructAligner from an XnaRefs library.

    with_ubs=False pc-ifies the constructs (N -> A), the library the DNA
    bootstrap reads are simulated from; the barcode context around the
    (removed) UB still distinguishes templates, so demux stays exact.
    """
    full = refs.full_targets  # also sets refs.insert_span
    ids = refs.xna_targets_id if xna_only else list(full)
    full = {tid: full[tid] for tid in ids}
    if not with_ubs:
        full = {tid: t.replace("N", "A") for tid, t in full.items()}
    lo = refs._BACKBONE_INSERT[0]
    # right flank length is backbone-derived and template-independent
    any_tid = next(iter(full))
    right_flank = len(refs.full_targets[any_tid]) - lo \
        - len(refs.targets[any_tid])
    return ConstructAligner(full, lo, right_flank, min_score=min_score)
