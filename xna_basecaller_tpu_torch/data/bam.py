"""Copied from ``xna_basecaller_tpu/data/bam.py:1-362``; the package
imports differ, and ``read_sam`` returns this package's
``eval/table.py::Table`` with the columns, dtypes and values of JAX's
pandas DataFrame (the machine with the card has no pandas).

BGZF + BAM binary alignment I/O without pysam/htslib.

The reference writes BAM through pysam's AlignmentFile
(ub-bonito/bonito/io.py:379-445) and reads SAM/BAM back into an
alignment dataframe with pysam (src/misc/data_io.py:505-563).  This
module re-implements both ends self-contained:

- ``BgzfWriter``: the BGZF container (SAM spec 4.1) — a series of
  spec-compliant gzip members, each with the two-byte ``BC`` extra field
  carrying the compressed block size, raw-deflate payload <= 64 KiB
  uncompressed, terminated by the fixed 28-byte EOF marker.  Because
  every block is a valid gzip member, any BGZF file written here is
  readable by the stdlib ``gzip`` module (and by samtools/pysam).
- ``BamWriter``/``read_bam``: the BAM record codec (SAM spec 4.2):
  binary header with reference dictionary, packed records (4-bit
  sequence, uint32 cigar ops, typed auxiliary tags).
- ``read_sam``: SAM *or* BAM -> the reference's alignment dataframe
  (same derived columns: target_cover, read_alignment_cover, is_pc,
  type, block_length, percent_match).

Non-ACGT basecalls (the XNA letters X/Y) have no code point in BAM's
4-bit alphabet; like htslib's ``seq_nt16_table`` we fold unknown letters
to N on encode.  Use text SAM/FASTQ when the X/Y letters themselves must
survive round-trip (the eval pipeline reads those, not BAM).
"""

from __future__ import annotations

import gzip
import re
import struct
import zlib

import numpy as np

from xna_basecaller_tpu_torch.data.writers import sam_record_fields

# Fixed empty final block that marks BGZF EOF (SAM spec 4.1.2).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_BLOCK_INPUT = 0xFF00  # uncompressed bytes per BGZF block (htslib's choice)

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_CODE = {c: i for i, c in enumerate(SEQ_NT16)}
CIGAR_OPS = "MIDNSHP=X"
_CIGAR_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

# cigar ops that consume query / reference (SAM spec table)
_CONSUMES_QUERY = frozenset("MIS=X")
_CONSUMES_REF = frozenset("MDN=X")


class BgzfWriter:
    """Blocked-gzip writer producing seekable, samtools-compatible BGZF."""

    def __init__(self, fileobj):
        self.fh = fileobj
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= _BLOCK_INPUT:
            self._flush_block(bytes(self.buf[:_BLOCK_INPUT]))
            del self.buf[:_BLOCK_INPUT]

    def _flush_block(self, data: bytes) -> None:
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        payload = comp.compress(data) + comp.flush()
        bsize = len(payload) + 25  # 18 header + payload + 8 trailer, minus 1
        self.fh.write(struct.pack(
            "<4BI2BH2B2H", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
            ord("B"), ord("C"), 2, bsize))
        self.fh.write(payload)
        self.fh.write(struct.pack("<II", zlib.crc32(data), len(data)))

    def close(self) -> None:
        if self.buf:
            self._flush_block(bytes(self.buf))
            self.buf.clear()
        self.fh.write(BGZF_EOF)
        self.fh.flush()


def _reg2bin(beg: int, end: int) -> int:
    """UCSC binning index (SAM spec 5.3)."""
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


_ARRAY_FMT = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I",
              "f": "f"}


def _encode_tag(tag: str) -> bytes:
    """One 'XX:T:value' SAM tag string -> BAM aux bytes.

    A ``B`` array ('ML:B:C,12,250') is written as the SAM spec (4.2.4)
    types it: ``B``, the subtype byte, a uint32 count and the packed
    little-endian values.  JAX's writer stores it as a ``Z`` string; the
    port does not copy that."""
    name, typ, value = tag.split(":", 2)
    out = name.encode()
    if typ == "i":
        return out + b"i" + struct.pack("<i", int(value))
    if typ == "f":
        return out + b"f" + struct.pack("<f", float(value))
    if typ == "A":
        return out + b"A" + value.encode()[:1]
    if typ == "B":
        sub, *items = value.split(",")
        if sub not in _ARRAY_FMT:
            raise ValueError(f"unknown B-array subtype {sub!r} in {tag!r}")
        conv = float if sub == "f" else int
        return (out + b"B" + sub.encode()
                + struct.pack(f"<I{len(items)}{_ARRAY_FMT[sub]}",
                              len(items), *map(conv, items)))
    return out + b"Z" + value.encode() + b"\0"  # Z and anything else


def _decode_tags(buf: bytes) -> list[str]:
    tags, i = [], 0
    int_fmt = {ord("c"): "<b", ord("C"): "<B", ord("s"): "<h",
               ord("S"): "<H", ord("i"): "<i", ord("I"): "<I"}
    while i < len(buf):
        name = buf[i:i + 2].decode()
        typ = buf[i + 2]
        i += 3
        if typ in int_fmt:
            fmt = int_fmt[typ]
            (v,) = struct.unpack_from(fmt, buf, i)
            i += struct.calcsize(fmt)
            tags.append(f"{name}:i:{v}")
        elif typ == ord("f"):
            (v,) = struct.unpack_from("<f", buf, i)
            i += 4
            tags.append(f"{name}:f:{v:g}")
        elif typ == ord("A"):
            tags.append(f"{name}:A:{chr(buf[i])}")
            i += 1
        elif typ in (ord("Z"), ord("H")):
            end = buf.index(0, i)
            tags.append(f"{name}:{chr(typ)}:{buf[i:end].decode()}")
            i = end + 1
        elif typ == ord("B"):
            sub = buf[i]
            fmt = int_fmt.get(sub, "<f")
            (n,) = struct.unpack_from("<I", buf, i + 1)
            width = struct.calcsize(fmt)
            vals = [struct.unpack_from(fmt, buf, i + 5 + k * width)[0]
                    for k in range(n)]
            i += 5 + n * width
            tags.append(f"{name}:B:" +
                        ",".join([chr(sub), *(str(v) for v in vals)]))
        else:
            raise ValueError(f"unknown BAM tag type {chr(typ)!r}")
    return tags


def encode_bam_record(fields: list[str], ref_ids: dict[str, int],
                      tags: list[str] | None = None) -> bytes:
    """Pack the 11 mandatory SAM fields (text form) into one BAM record."""
    qname, flag, rname, pos1, mapq, cigar, _, _, _, seq, qual = fields[:11]
    ref_id = ref_ids.get(rname, -1)
    pos = int(pos1) - 1
    ops = _CIGAR_RE.findall(cigar) if cigar != "*" else []
    ref_span = sum(int(n) for n, op in ops if op in _CONSUMES_REF)
    bin_ = _reg2bin(pos, pos + max(ref_span, 1)) if ref_id >= 0 else 4680
    name_b = qname.encode() + b"\0"
    cigar_b = b"".join(
        struct.pack("<I", (int(n) << 4) | _CIGAR_CODE[op]) for n, op in ops)
    l_seq = 0 if seq == "*" else len(seq)
    seq_b = bytearray((l_seq + 1) // 2)
    for i in range(l_seq):
        c = seq[i].upper()
        # the XNA letters X/Y are NOT IUPAC codes: fold both to N rather
        # than letting Y collide with IUPAC Y (pyrimidine) at code 9
        code = 15 if c in "XY" else _NT16_CODE.get(c, 15)
        seq_b[i // 2] |= code << (4 if i % 2 == 0 else 0)
    if qual in ("*", "") or l_seq == 0:
        qual_b = b"\xff" * l_seq
    else:
        qual_b = bytes(ord(c) - 33 for c in qual)
    aux = b"".join(_encode_tag(t) for t in (tags or []))
    body = struct.pack(
        "<iiBBHHHiiii", ref_id, pos, len(name_b), int(mapq), bin_,
        len(ops), int(flag), l_seq, -1, -1, 0)
    body += name_b + cigar_b + bytes(seq_b) + qual_b + aux
    return struct.pack("<i", len(body)) + body


class BamWriter:
    """Binary BAM writer with the same .write API as SamWriter
    (reference io.py:379-445)."""

    def __init__(self, path: str, targets: dict[str, str] | None = None,
                 program: str = "xnacall", read_group: str | None = None):
        self.raw = open(path, "wb")
        self.bgzf = BgzfWriter(self.raw)
        self.read_group = read_group
        targets = targets or {}
        self.ref_ids = {name: i for i, name in enumerate(targets)}
        text = "@HD\tVN:1.5\tSO:unknown\n"
        for name, seq in targets.items():
            text += f"@SQ\tSN:{name}\tLN:{len(seq)}\n"
        if read_group:
            text += f"@RG\tID:{read_group}\tPL:ONT\n"
        text += f"@PG\tID:basecaller\tPN:{program}\n"
        text_b = text.encode()
        self.bgzf.write(b"BAM\x01" + struct.pack("<i", len(text_b)) + text_b)
        self.bgzf.write(struct.pack("<i", len(targets)))
        for name, seq in targets.items():
            name_b = name.encode() + b"\0"
            self.bgzf.write(struct.pack("<i", len(name_b)) + name_b +
                            struct.pack("<i", len(seq)))

    def write(self, read_id: str, seq: str, qstring: str,
              mapping: dict | None = None, tags: list[str] | None = None):
        fields = sam_record_fields(read_id, seq, qstring, mapping)
        if self.read_group:
            tags = [f"RG:Z:{self.read_group}"] + (tags or [])
        self.bgzf.write(encode_bam_record(fields, self.ref_ids, tags))

    def close(self) -> None:
        self.bgzf.close()
        self.raw.close()


def read_bam(path: str):
    """Decode a BAM file -> (references, records).

    references: list of (name, length).  Each record is a dict with
    query_name/flag/ref_id/pos/mapq/cigar [(op, len)]/seq/qual/tags.
    """
    with gzip.open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        name = data[off + 4: off + 4 + l_name - 1].decode()
        (l_ref,) = struct.unpack_from("<i", data, off + 4 + l_name)
        refs.append((name, l_ref))
        off += 8 + l_name
    records = []
    while off < len(data):
        (block_size,) = struct.unpack_from("<i", data, off)
        body = data[off + 4: off + 4 + block_size]
        off += 4 + block_size
        (ref_id, pos, l_name, mapq, _bin, n_cigar, flag, l_seq,
         _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", body)
        p = 32
        qname = body[p: p + l_name - 1].decode()
        p += l_name
        cigar = []
        for _ in range(n_cigar):
            (v,) = struct.unpack_from("<I", body, p)
            cigar.append((CIGAR_OPS[v & 0xF], v >> 4))
            p += 4
        seq = "".join(
            SEQ_NT16[(body[p + i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF]
            for i in range(l_seq))
        p += (l_seq + 1) // 2
        qual_raw = body[p: p + l_seq]
        qual = ("*" if not l_seq or qual_raw[0] == 0xFF
                else "".join(chr(q + 33) for q in qual_raw))
        p += l_seq
        records.append(dict(
            query_name=qname, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
            cigar=cigar, seq=seq, qual=qual, tags=_decode_tags(body[p:])))
    return refs, records


def _parse_sam_text(path: str):
    """Text SAM -> (references, records) in read_bam's shape."""
    refs, records = [], []
    ref_ids = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    d = dict(f.split(":", 1) for f in line.split("\t")[1:]
                             if ":" in f)
                    ref_ids[d["SN"]] = len(refs)
                    refs.append((d["SN"], int(d["LN"].strip())))
                continue
            f = line.rstrip("\n").split("\t")
            cigar = ([(op, int(n)) for n, op in _CIGAR_RE.findall(f[5])]
                     if f[5] != "*" else [])
            records.append(dict(
                query_name=f[0], flag=int(f[1]),
                ref_id=ref_ids.get(f[2], -1), pos=int(f[3]) - 1,
                mapq=int(f[4]), cigar=cigar, seq=f[9], qual=f[10],
                tags=f[11:]))
    return refs, records


def read_sam(sam_filepath: str, verbose: bool = False):
    """SAM/BAM -> the reference's alignment table
    (src/misc/data_io.py:505-563: same columns and derived metrics), as a
    ``Table`` whose columns have the dtypes of JAX's DataFrame: the read
    and target ids, strand and type as objects, the counts int64, the
    covers float64 (0/0 is NaN, as pandas divides), ``is_pc`` bool."""
    from xna_basecaller_tpu_torch.eval.table import Table

    refs, records = (read_bam(sam_filepath)
                     if sam_filepath.endswith(".bam")
                     else _parse_sam_text(sam_filepath))
    rows = []
    for r in records:
        cigar = r["cigar"]
        qlen = (len(r["seq"]) if r["seq"] != "*" else
                sum(n for op, n in cigar if op in _CONSUMES_QUERY))
        clip_l = 0
        for op, n in cigar:
            if op not in "SH":
                break
            clip_l += n if op == "S" else 0
        clip_r = 0
        for op, n in reversed(cigar):
            if op not in "SH":
                break
            clip_r += n if op == "S" else 0
        n_matches = sum(n for op, n in cigar if op in "M=X")
        ref_span = sum(n for op, n in cigar if op in _CONSUMES_REF)
        ref_name, ref_len = (refs[r["ref_id"]] if 0 <= r["ref_id"] < len(refs)
                             else ("*", 0))
        rows.append(dict(
            read_id=r["query_name"], read_length=qlen,
            read_start=clip_l, read_end=qlen - clip_r,
            strand="-" if r["flag"] & 16 else "+",
            target_id=ref_name, target_length=ref_len,
            target_start=r["pos"], target_end=r["pos"] + ref_span,
            n_matches=n_matches,
            read_alignment_length=qlen - clip_l - clip_r,
            mapping_quality=r["mapq"]))
    sam_df = Table.from_records(rows)
    if len(sam_df) == 0:
        return sam_df
    n = sam_df["n_matches"].astype(float)
    with np.errstate(divide="ignore", invalid="ignore"):
        sam_df["target_cover"] = n / sam_df["target_length"].astype(float)
        sam_df["read_alignment_length"] = (sam_df["read_end"]
                                           - sam_df["read_start"])
        sam_df["read_alignment_cover"] = (
            n / sam_df["read_alignment_length"].astype(float))
    sam_df["is_pc"] = np.array(
        [t.startswith("PC") for t in sam_df["target_id"]], bool)
    sam_df["type"] = ["PC" if v else "XNA" for v in sam_df["is_pc"]]
    sam_df["block_length"] = sam_df["read_alignment_length"]
    sam_df["percent_match"] = sam_df["read_alignment_cover"]
    if verbose:
        print("paf number of alignments: {:0,d}".format(len(sam_df)))
    return sam_df


def sam_to_paf_records(sam_filepath: str) -> list[dict]:
    """SAM/BAM alignments -> the PAF record dicts eval.analyze consumes
    (the reference's analyze_paf SAM input path, analyze_paf.py:576-578).

    SAM carries no cs tag, so sequence-level UB analysis is unavailable
    from this input — identical to the reference's SAM mode.
    """
    df = read_sam(sam_filepath)
    records = []
    for row in df.records():
        records.append(dict(
            read_id=row["read_id"], read_length=int(row["read_length"]),
            read_start=int(row["read_start"]), read_end=int(row["read_end"]),
            strand=row["strand"], target_id=row["target_id"],
            target_length=int(row["target_length"]),
            target_start=int(row["target_start"]),
            target_end=int(row["target_end"]),
            n_matches=int(row["n_matches"]),
            alignment_block_length=int(row["block_length"]),
            mapping_quality=int(row["mapping_quality"]), cs="",
            target_cover=float(row["target_cover"]),
            percent_match=float(row["percent_match"])))
    return records
