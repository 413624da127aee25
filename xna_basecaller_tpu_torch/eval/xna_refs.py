"""Copied from ``xna_basecaller_tpu/eval/xna_refs.py`` (the template
libraries, ``XnaRefs`` and ``identify_ref``); the FASTA files are this
package's copy under ``assets/xna_libs``.

XNA reference/template database.

Re-implements the reference's library definitions (reference:
src/misc/xna_refs.py:28-431): POC (= XNA16 + XNA_4Ds, 20 templates) and
CPLX (XNA1024, 1024 templates) with primers, barcode slices, UB positions
(forward and reverse), UB k-mer extraction, complement-PC mapping, and read
location from the barcode.  Template FASTAs ship as package assets
(xna_libs/*/refdb_short.fasta); a custom library dir can be given.
"""

from __future__ import annotations

import os
import re

from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str

ASSETS_LIBS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "xna_libs")

VALID_REFS = ["POC", "CPLX", "XNA16", "XNA_4Ds"]

EXP_REF_MAP = {
    "POC": "POC", "CPLX": "CPLX",
    "A003": "XNA16",
    "A007": "XNA_4Ds", "A008": "XNA_4Ds", "A007+A008": "XNA_4Ds",
}


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


# Per-library primer geometry (reference xna_refs.py:85-120)
_GEOMETRY = {
    "XNA16": dict(barcode_len=24, left_primer_len=25, middle_primer_len=24,
                  right_primer_len=26,
                  left_primer="TTTTTTTTGCGTAGCGGGATCCAGC",
                  middle_primer="ACGATAATACGACTCACTATAGGG",
                  right_primer="CCGTCATAGCTGTTTCCTGTGTGAAA"),
    "XNA_4Ds": dict(barcode_len=24, left_primer_len=25, middle_primer_len=19,
                    right_primer_len=23),
    "CPLX": dict(barcode_len=30, left_primer_len=23, middle_primer_len=2,
                 right_primer_len=23,
                 left_primer="TTTTTTGCGTAGCGGTATGCGTA",
                 middle_primer="AT",
                 right_primer="TATGGCAGCTGTTTCATGTGTGA"),
}

_4DS_ALIASES = {
    "XNA17": "84Ds4-AA", "PC17": "PC_84Ds4-AA",
    "XNA18": "84Ds4-AB", "PC18": "PC_84Ds4-AB",
    "XNA19": "84Ds4-AC", "PC19": "PC_84Ds4-AC",
    "XNA20": "84Ds4-AD", "PC20": "PC_84Ds4-AD",
}


class XnaRefs:
    """Template database for one library (or the merged POC library)."""

    def __init__(self, ref_name: str, refs_dir: str | None = None,
                 use_aliases: bool = False):
        if ref_name not in VALID_REFS:
            raise ValueError(
                f"Invalid ref_name ({ref_name}), choose among: {VALID_REFS}")
        self.ref_name = ref_name
        refs_dir = refs_dir or ASSETS_LIBS

        if ref_name == "POC":
            # POC = XNA16 + XNA_4Ds merged (reference xna_refs.py:121-149)
            sub16 = XnaRefs("XNA16", refs_dir)
            sub4 = XnaRefs("XNA_4Ds", refs_dir, use_aliases=True)
            self.barcode_len = sub16.barcode_len
            self.left_primer_len = sub16.left_primer_len
            self.middle_primer_len = sub16.middle_primer_len
            self.right_primer_len = sub16.right_primer_len
            self.left_primer = sub16.left_primer
            self.targets = {**sub16.targets, **sub4.targets}
            for attr in ("barcodes", "barcodes_pos", "xna_kmers",
                         "xna_kmers_pos", "xna_kmers_len", "x_pos",
                         "x_pos_rev", "len_targets"):
                merged = {**getattr(sub16, attr), **getattr(sub4, attr)}
                setattr(self, attr, merged)
            self._finalise()
            return

        geom = _GEOMETRY[ref_name]
        for k, v in geom.items():
            setattr(self, k, v)
        self.left_primer = geom.get("left_primer", "")

        path = os.path.join(refs_dir, ref_name, "refdb_short.fasta")
        self.targets = read_fasta(path)

        if ref_name == "XNA_4Ds":
            # add PC aliases (reference xna_refs.py:166-183)
            if not any(t.startswith("PC") for t in self.targets):
                for tid in list(self.targets):
                    self.targets["PC_" + tid] = self.targets[tid]
            if use_aliases:
                rev = {v: k for k, v in _4DS_ALIASES.items()}
                self.targets = {rev.get(k, k): v
                                for k, v in self.targets.items()}

        self.barcodes = {}
        self.barcodes_pos = {}
        self.xna_kmers = {}
        self.xna_kmers_pos = {}
        self.xna_kmers_len = {}
        self.x_pos = {}
        self.x_pos_rev = {}
        self.len_targets = {}

        bc_slice = slice(self.left_primer_len,
                         self.left_primer_len + self.barcode_len)
        kmer_start = (self.left_primer_len + self.barcode_len
                      + self.middle_primer_len)

        for tid, tar in self.targets.items():
            ks = slice(kmer_start, len(tar) - self.right_primer_len)
            if tid == "PC15" and ref_name == "XNA16":
                # PC15's left primer is one base shorter
                # (reference xna_refs.py:87-88, 274-281)
                bsl = slice(bc_slice.start - 1, bc_slice.stop - 1)
                ks = slice(kmer_start - 1, len(tar) - self.right_primer_len)
            else:
                bsl = bc_slice
            self.len_targets[tid] = len(tar)
            self.barcodes[tid] = tar[bsl]
            self.barcodes_pos[tid] = (bsl.start, bsl.stop)
            self.xna_kmers[tid] = tar[ks]
            self.xna_kmers_pos[tid] = (ks.start, ks.start + len(tar[ks]))
            self.xna_kmers_len[tid] = len(tar[ks])
            self.x_pos[tid] = [m.start() for m in re.finditer("N", tar)]
            self.x_pos_rev[tid] = [len(tar) - p - 1
                                   for p in self.x_pos[tid][::-1]]
        self._finalise()

    def _finalise(self):
        self.targets_id = list(self.targets)
        self.xna_targets_id = [t for t in self.targets_id
                               if not t.startswith("PC")]
        self.pc_targets_id = [t for t in self.targets_id
                              if t.startswith("PC")]
        all_bcs = list(self.barcodes.values())
        self.barcodes_cnt = {t: all_bcs.count(b)
                             for t, b in self.barcodes.items()}

    # ------------------------------------------------------------------
    # Full-length construct library.  Real library molecules are ~2.7 kb
    # vector constructs with the short template embedded; reads are
    # fragments of the construct, so every basecalled chunk aligns with
    # near-full coverage (reference xna_libs/CPLX/refdb.fasta: 1024
    # records, identical backbone outside the insert at [1214, 1303),
    # UB as 'X' at position 1274; verified record-exact against
    # backbone[:1214] + refdb_short[tid] + backbone[1303:]).
    # POC libraries ship no full refdb; their constructs reuse the CPLX
    # backbone flanks around each short template (simulation scaffold).
    # ------------------------------------------------------------------
    _BACKBONE_INSERT = (1214, 1303)  # canonical insert span in backbone

    @property
    def full_targets(self) -> dict[str, str]:
        """tid -> full-length construct, UBs encoded 'N' (like targets)."""
        if not hasattr(self, "_full_targets"):
            lo, hi = self._BACKBONE_INSERT
            backbone = read_fasta(os.path.join(
                ASSETS_LIBS, "CPLX", "backbone.fasta"))["backbone_AAAAA"]
            left, right = backbone[:lo], backbone[hi:]
            self._full_targets = {
                tid: left + tar + right
                for tid, tar in self.targets.items()}
            self.insert_span = (lo, lo + max(
                len(t) for t in self.targets.values()))
        return self._full_targets

    def full_ub_positions(self, tid: str) -> list[int]:
        """UB positions of ``tid`` in full-construct coordinates."""
        lo = self._BACKBONE_INSERT[0]
        return [lo + p for p in self.x_pos[tid]]

    def locate_read(self, barcode_start, barcode_end, target_id, strand,
                    length):
        """Read-coordinate span of the template region from the barcode
        match (reference xna_refs.py:296-311)."""
        read_start = barcode_start - self.left_primer_len
        read_end = (barcode_end + self.middle_primer_len
                    + self.xna_kmers_len[target_id] + self.right_primer_len)
        if target_id == "PC15" and self.ref_name in ("XNA16", "POC"):
            read_start -= 1
        if strand == "R":
            read_start, read_end = length - read_end, length - read_start
        return read_start, read_end

    def get_complement_target_id(self, target_id: str) -> str:
        """XNA<->PC pairing (reference xna_refs.py:313-336)."""
        if self.ref_name == "CPLX":
            return target_id
        suffix_len = 3 if target_id.startswith(("84", "PC_8")) else 2
        if target_id.startswith("PC"):
            suffix = target_id[suffix_len:]
            return next(t for t in self.targets_id
                        if t.endswith(suffix) and not t.startswith("PC"))
        pcs = [t for t in self.targets_id if t.startswith("PC")]
        return next(t for t in pcs if target_id.endswith(t[suffix_len:]))

    def get_ub_kmers(self, target_id: str, x_pos: int | None = None,
                     reverse: bool = False, kmer_len: int = 6):
        """All k-mers covering a UB (reference xna_refs.py:368-402)."""
        if x_pos is None:
            return [self.get_ub_kmers(target_id, p, reverse, kmer_len)
                    for p in self.x_pos[target_id]]
        tar = self.targets[target_id]
        window = tar[x_pos - kmer_len + 1: x_pos + kmer_len]
        kmers = [window[i:i + kmer_len]
                 for i in range(len(window) - kmer_len + 1)]
        if reverse:
            kmers = [reverse_complement_str(k.replace("N", "X"))
                     for k in kmers[::-1]]
        return kmers


def identify_ref(target_ids) -> XnaRefs | None:
    """Find the library containing the given template ids
    (reference xna_refs.py:417-431)."""
    for ref_name in VALID_REFS:
        refs = XnaRefs(ref_name)
        if set(refs.targets_id) & set(target_ids):
            return refs
    return None
