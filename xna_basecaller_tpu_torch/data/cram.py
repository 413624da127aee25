"""Copied from ``xna_basecaller_tpu/data/cram.py:1-554``, code unchanged.
The file definition's id stays JAX's ``xna_basecaller_tpu``, so that both
packages write the same bytes.

CRAM 3.0 container writer/reader (pure python, stdlib only).

The reference emits CRAM through pysam/htslib when the user picks a
`.cram` output (io.py:391-401 — `AlignmentFile(fd, mode)` with a `wc`
mode from `biofmt`).  Neither pysam nor samtools exists in this
environment, so this module speaks the container format directly:

* file definition + containers + blocks with ITF8/LTF8 varints and
  CRC32s (CRAM 3.0 spec §6-§8);
* one compression-header block per container: preservation map
  (RN=true, AP=false, RR=false + TD tag dictionary), data-series
  encoding map (EXTERNAL codec per series; BYTE_ARRAY_STOP for read
  names), tag encoding map (BYTE_ARRAY_LEN over external blocks);
* single-slice containers of UNMAPPED records: BF/CF/RL/AP/RG/RN/
  mate-info/TL then per-base BA bases and QS qualities — the
  basecaller's unaligned output stream (aligned container output is
  served by the BAM codec in data/bam.py, as the reference serves it
  through htslib);
* the spec's fixed 38-byte EOF container.

Self-validation: the writer's own serializer reproduces the spec's EOF
container byte-for-byte (tests/test_torch_cram.py) — pinning the ITF8/LTF8,
container-header, block and CRC arithmetic to the published constant —
and every file round-trips through the reader.  No external validator
exists in this environment (documented in PARITY.md).
"""

from __future__ import annotations

import gzip
import io
import struct
import zlib

# block content types (spec §8.1)
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5

# block compression methods
M_RAW = 0
M_GZIP = 1

# external block content ids, one per data series
SERIES = ["BF", "CF", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS",
          "TL", "BA", "QS"]
CID = {name: i + 1 for i, name in enumerate(SERIES)}
CID_TAGS = len(SERIES) + 1

EOF_BYTES = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f"
    "0001000606010001000100ee63014b")


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def itf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def itf8_decode(buf, pos: int) -> tuple[int, int]:
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | buf[pos + 1], pos + 2
    if b0 < 0xE0:
        return ((b0 & 0x1F) << 16) | (buf[pos + 1] << 8) | buf[pos + 2], \
            pos + 3
    if b0 < 0xF0:
        return ((b0 & 0x0F) << 24) | (buf[pos + 1] << 16) \
            | (buf[pos + 2] << 8) | buf[pos + 3], pos + 4
    v = ((b0 & 0x0F) << 28) | (buf[pos + 1] << 20) | (buf[pos + 2] << 12) \
        | (buf[pos + 3] << 4) | (buf[pos + 4] & 0x0F)
    return v, pos + 5


def itf8_signed(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


def ltf8_encode(v: int) -> bytes:
    v &= (1 << 64) - 1
    bounds = [(1 << 7, 0, 0x00), (1 << 14, 1, 0x80), (1 << 21, 2, 0xC0),
              (1 << 28, 3, 0xE0), (1 << 35, 4, 0xF0), (1 << 42, 5, 0xF8),
              (1 << 49, 6, 0xFC), (1 << 56, 7, 0xFE)]
    for lim, extra, prefix in bounds:
        if v < lim:
            out = [prefix | (v >> (8 * extra))]
            for k in range(extra - 1, -1, -1):
                out.append((v >> (8 * k)) & 0xFF)
            return bytes(out)
    return bytes([0xFF]) + v.to_bytes(8, "big")


def ltf8_decode(buf, pos: int) -> tuple[int, int]:
    b0 = buf[pos]
    if b0 == 0xFF:
        return int.from_bytes(buf[pos + 1:pos + 9], "big"), pos + 9
    n_extra = 0
    mask = 0x80
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    v = b0 & (0xFF >> (n_extra + (1 if n_extra else 0)))
    for k in range(n_extra):
        v = (v << 8) | buf[pos + 1 + k]
    return v, pos + 1 + n_extra


# ---------------------------------------------------------------------------
# blocks and containers
# ---------------------------------------------------------------------------

def encode_block(ctype: int, cid: int, data: bytes,
                 method: int = M_RAW) -> bytes:
    if method == M_GZIP:
        comp = gzip.compress(data, 6)
    else:
        comp = data
    out = bytes([method, ctype]) + itf8_encode(cid) \
        + itf8_encode(len(comp)) + itf8_encode(len(data)) + comp
    return out + struct.pack("<I", zlib.crc32(out))


def decode_block(buf, pos: int):
    start = pos
    method, ctype = buf[pos], buf[pos + 1]
    pos += 2
    cid, pos = itf8_decode(buf, pos)
    csize, pos = itf8_decode(buf, pos)
    rsize, pos = itf8_decode(buf, pos)
    comp = bytes(buf[pos:pos + csize])
    pos += csize
    crc = struct.unpack("<I", buf[pos:pos + 4])[0]
    if crc != zlib.crc32(buf[start:pos]):
        raise ValueError("block CRC mismatch")
    pos += 4
    data = gzip.decompress(comp) if method == M_GZIP else comp
    if len(data) != rsize:
        raise ValueError("block raw size mismatch")
    return {"ctype": ctype, "cid": cid, "data": data}, pos


def encode_container(ref_id: int, start: int, span: int, n_records: int,
                     counter: int, bases: int, blocks: list[bytes],
                     landmarks: list[int]) -> bytes:
    body = b"".join(blocks)
    hdr = struct.pack("<i", len(body))
    hdr += itf8_encode(ref_id) + itf8_encode(start) + itf8_encode(span)
    hdr += itf8_encode(n_records) + ltf8_encode(counter) \
        + ltf8_encode(bases) + itf8_encode(len(blocks))
    hdr += itf8_encode(len(landmarks))
    for lm in landmarks:
        hdr += itf8_encode(lm)
    return hdr + struct.pack("<I", zlib.crc32(hdr)) + body


def decode_container_header(buf, pos: int):
    start0 = pos
    (length,) = struct.unpack("<i", buf[pos:pos + 4])
    pos += 4
    ref_id, pos = itf8_decode(buf, pos)
    start, pos = itf8_decode(buf, pos)
    span, pos = itf8_decode(buf, pos)
    n_records, pos = itf8_decode(buf, pos)
    counter, pos = ltf8_decode(buf, pos)
    bases, pos = ltf8_decode(buf, pos)
    n_blocks, pos = itf8_decode(buf, pos)
    n_lm, pos = itf8_decode(buf, pos)
    landmarks = []
    for _ in range(n_lm):
        lm, pos = itf8_decode(buf, pos)
        landmarks.append(lm)
    crc = struct.unpack("<I", buf[pos:pos + 4])[0]
    if crc != zlib.crc32(buf[start0:pos]):
        raise ValueError("container CRC mismatch")
    pos += 4
    return {"length": length, "ref_id": itf8_signed(ref_id),
            "start": start, "span": span, "n_records": n_records,
            "counter": counter, "bases": bases, "n_blocks": n_blocks,
            "landmarks": landmarks}, pos


def eof_container() -> bytes:
    """The spec's EOF container, built through this module's own
    serializer (must equal EOF_BYTES — asserted in tests)."""
    cmp_hdr = encode_block(CT_COMPRESSION_HEADER, 0,
                           b"\x01\x00\x01\x00\x01\x00")
    return encode_container(-1, 4542278, 0, 0, 0, 0, [cmp_hdr], [])


# ---------------------------------------------------------------------------
# maps (compression header)
# ---------------------------------------------------------------------------

def _cram_map(entries: list[bytes]) -> bytes:
    content = itf8_encode(len(entries)) + b"".join(entries)
    return itf8_encode(len(content)) + content


def _ext_encoding(cid: int) -> bytes:
    """EXTERNAL codec (id 1): args = itf8 content id."""
    args = itf8_encode(cid)
    return itf8_encode(1) + itf8_encode(len(args)) + args


def _byte_array_stop_encoding(stop: int, cid: int) -> bytes:
    """BYTE_ARRAY_STOP codec (id 5): args = stop byte + itf8 content id."""
    args = bytes([stop]) + itf8_encode(cid)
    return itf8_encode(5) + itf8_encode(len(args)) + args


def _byte_array_len_encoding(cid: int) -> bytes:
    """BYTE_ARRAY_LEN codec (id 4): args = length encoding + value
    encoding, both EXTERNAL into the same block here."""
    args = _ext_encoding(cid) + _ext_encoding(cid)
    return itf8_encode(4) + itf8_encode(len(args)) + args


_B_SUBTYPE_FMT = {"c": "b", "C": "B", "s": "h", "S": "H",
                  "i": "i", "I": "I", "f": "f"}


def _tag_value_bytes(vtype: str, val: str) -> bytes:
    """SAM-text tag value -> BAM binary typing (SAM spec §4.2.4): CRAM
    tag streams carry BAM-typed bytes, and the TD dictionary declares the
    real type code — a spec-conformant reader (htslib/pysam) decodes by
    that code, so e.g. an ML:B:C,... array must be a typed array, not
    NUL-terminated ASCII."""
    if vtype in ("Z", "H"):
        return val.encode() + b"\x00"
    if vtype == "A":
        return val.encode()[:1]
    if vtype == "i":
        iv = int(val)
        if not (-2**31 <= iv < 2**31):
            raise ValueError(
                f"SAM 'i' tag value {iv} exceeds int32 (BAM typing); "
                "use a Z tag for larger values")
        return struct.pack("<i", iv)
    if vtype == "f":
        return struct.pack("<f", float(val))
    if vtype == "B":
        parts = val.split(",")
        sub, items = parts[0], parts[1:]
        fmt = _B_SUBTYPE_FMT[sub]
        conv = float if sub == "f" else int
        return (sub.encode() + struct.pack("<i", len(items))
                + struct.pack("<%d%s" % (len(items), fmt),
                              *[conv(x) for x in items]))
    raise ValueError(f"unsupported SAM tag type {vtype!r}")


def _tag_value_str(vtype: str, raw: bytes) -> str:
    """Inverse of _tag_value_bytes: BAM-typed bytes -> SAM text value."""
    if vtype in ("Z", "H"):
        return raw[:-1].decode()
    if vtype == "A":
        return raw[:1].decode()
    if vtype == "i":
        return str(struct.unpack("<i", raw[:4])[0])
    if vtype == "f":
        # numpy float32 shortest repr: "0.1" round-trips as "0.1", not
        # the double-expanded "0.10000000149011612"
        import numpy as _np
        return str(_np.float32(struct.unpack("<f", raw[:4])[0]))
    if vtype == "B":
        sub = chr(raw[0])
        n = struct.unpack("<i", raw[1:5])[0]
        vals = struct.unpack("<%d%s" % (n, _B_SUBTYPE_FMT[sub]), raw[5:])
        if sub == "f":
            import numpy as _np
            vals = [_np.float32(v) for v in vals]
        return ",".join([sub] + [str(v) for v in vals])
    raise ValueError(f"unsupported SAM tag type {vtype!r}")


def compression_header(tag_lines: list[bytes],
                       tag_keys: list[bytes]) -> bytes:
    pres = [
        b"AP" + b"\x00",             # AP delta off: absolute positions
        b"RN" + b"\x01",             # read names preserved
        b"RR" + b"\x00",             # no reference required
    ]
    td = b"\x00".join(tag_lines) + b"\x00"
    pres.append(b"TD" + itf8_encode(len(td)) + td)
    ds = [key.encode() + (_byte_array_stop_encoding(0, CID["RN"])
                          if key == "RN" else _ext_encoding(CID[key]))
          for key in SERIES]
    tags = []
    for key in tag_keys:  # 3 bytes: tag0 tag1 vtype
        kid = (key[0] << 16) | (key[1] << 8) | key[2]
        tags.append(itf8_encode(kid) + _byte_array_len_encoding(CID_TAGS))
    return _cram_map(pres) + _cram_map(ds) + _cram_map(tags)


def _parse_maps(data: bytes):
    pos = 0
    out = []
    for _ in range(3):
        size, pos = itf8_decode(data, pos)
        out.append(data[pos:pos + size])
        pos += size
    return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class CramWriter:
    """CRAM 3.0 writer of unmapped records; same .write API as BamWriter
    (reference io.py:379-445 Writer with a pysam 'wc' mode)."""

    def __init__(self, path_or_fd, targets: dict[str, str] | None = None,
                 program: str = "xnacall", read_group: str | None = None,
                 records_per_container: int = 8192):
        self.fh = open(path_or_fd, "wb") \
            if isinstance(path_or_fd, str) else path_or_fd
        self.read_group = read_group
        self.records_per_container = records_per_container
        self._records: list[tuple] = []
        self._counter = 0
        targets = targets or {}
        text = "@HD\tVN:1.5\tSO:unknown\n"
        for name, seq in targets.items():
            text += f"@SQ\tSN:{name}\tLN:{len(seq)}\n"
        if read_group:
            text += f"@RG\tID:{read_group}\tPL:ONT\n"
        text += f"@PG\tID:basecaller\tPN:{program}\n"
        self.header_text = text
        self.fh.write(b"CRAM\x03\x00" + b"xna_basecaller_tpu"[:20]
                      .ljust(20, b"\x00"))
        hdr = struct.pack("<i", len(text.encode())) + text.encode()
        blk = encode_block(CT_FILE_HEADER, 0, hdr)
        self.fh.write(encode_container(0, 0, 0, 0, 0, 0, [blk], [0]))

    def write(self, read_id: str, seq: str, qstring: str,
              mapping: dict | None = None,
              tags: list[str] | None = None) -> None:
        # unmapped-record container format: alignment-carrying output is
        # data/bam.py (see module docstring)
        tag_list = []
        if self.read_group:
            tag_list.append(("RG", "Z", self.read_group))
        for t in tags or []:
            k, vtype, val = t.split(":", 2)
            tag_list.append((k, vtype, val))
        self._records.append((read_id, seq, qstring, tuple(tag_list)))
        if len(self._records) >= self.records_per_container:
            self._flush()

    def _flush(self) -> None:
        if not self._records:
            return
        streams = {k: bytearray() for k in SERIES}
        tag_stream = bytearray()
        tag_lines: list[bytes] = []
        line_index: dict[bytes, int] = {}
        tag_keys: list[bytes] = []
        n_bases = 0
        for read_id, seq, qstring, tag_list in self._records:
            line = b"".join(
                k.encode() + v.encode() for k, v, _ in tag_list)
            if line not in line_index:
                line_index[line] = len(tag_lines)
                tag_lines.append(line)
                for k, v, _ in tag_list:
                    key = k.encode() + v.encode()
                    if key not in tag_keys:
                        tag_keys.append(key)
            streams["BF"] += itf8_encode(4)       # BAM flag: unmapped
            streams["CF"] += itf8_encode(3)       # qual stored | detached
            streams["RL"] += itf8_encode(len(seq))
            streams["AP"] += itf8_encode(0)
            streams["RG"] += itf8_encode(0xFFFFFFFF if not self.read_group
                                         else 0)
            streams["RN"] += read_id.encode() + b"\x00"
            streams["MF"] += itf8_encode(0)
            streams["NS"] += itf8_encode(0xFFFFFFFF)
            streams["NP"] += itf8_encode(0)
            streams["TS"] += itf8_encode(0)
            streams["TL"] += itf8_encode(line_index[line])
            streams["BA"] += seq.encode()
            if qstring and qstring != "*":
                streams["QS"] += bytes(ord(c) - 33 for c in qstring)
            else:
                streams["QS"] += b"\xff" * len(seq)
            for k, vtype, val in tag_list:
                data = _tag_value_bytes(vtype, val)
                tag_stream += itf8_encode(len(data)) + data
            n_bases += len(seq)

        comp_blk = encode_block(CT_COMPRESSION_HEADER, 0,
                                compression_header(tag_lines, tag_keys))
        ext_blocks = []
        content_ids = []
        for k in SERIES:
            ext_blocks.append(encode_block(
                CT_EXTERNAL, CID[k], bytes(streams[k]),
                method=M_GZIP if k in ("BA", "QS", "RN") else M_RAW))
            content_ids.append(CID[k])
        if tag_stream:
            ext_blocks.append(encode_block(CT_EXTERNAL, CID_TAGS,
                                           bytes(tag_stream)))
            content_ids.append(CID_TAGS)
        core_blk = encode_block(CT_CORE, 0, b"")

        sh = itf8_encode(0xFFFFFFFF)              # ref id -1: unmapped
        sh += itf8_encode(0) + itf8_encode(0)     # start, span
        sh += itf8_encode(len(self._records))
        sh += ltf8_encode(self._counter)
        sh += itf8_encode(1 + len(ext_blocks))    # core + externals
        sh += itf8_encode(len(content_ids))
        for cid in content_ids:
            sh += itf8_encode(cid)
        sh += itf8_encode(0xFFFFFFFF)             # no embedded reference
        sh += b"\x00" * 16                        # md5 (no reference)
        slice_blk = encode_block(CT_SLICE_HEADER, 0, sh)

        blocks = [comp_blk, slice_blk, core_blk] + ext_blocks
        landmarks = [len(comp_blk)]
        self.fh.write(encode_container(
            -1, 0, 0, len(self._records), self._counter, n_bases,
            blocks, landmarks))
        self._counter += len(self._records)
        self._records = []

    def close(self) -> None:
        self._flush()
        self.fh.write(eof_container())
        self.fh.flush()
        if hasattr(self.fh, "close"):
            self.fh.close()


# ---------------------------------------------------------------------------
# reader (round-trip validation + downstream consumption)
# ---------------------------------------------------------------------------

def _read_encoding(data, pos):
    codec, pos = itf8_decode(data, pos)
    alen, pos = itf8_decode(data, pos)
    args = data[pos:pos + alen]
    return {"codec": codec, "args": args}, pos + alen


def read_cram(path: str):
    """Parse a CRAM file written by CramWriter: returns
    (header_text, records) with records as dicts of
    read_id/seq/qstring/tags."""
    buf = open(path, "rb").read()
    if buf[:4] != b"CRAM" or buf[4] != 3:
        raise ValueError("not a CRAM 3.x file")
    pos = 26
    hdr, pos = decode_container_header(buf, pos)
    blk, pos = decode_block(buf, pos)
    if blk["ctype"] != CT_FILE_HEADER:
        raise ValueError("missing SAM header container")
    (tlen,) = struct.unpack("<i", blk["data"][:4])
    header_text = blk["data"][4:4 + tlen].decode()

    records = []
    while pos < len(buf):
        if buf[pos:pos + len(EOF_BYTES)] == EOF_BYTES:
            pos += len(EOF_BYTES)
            break
        chdr, pos = decode_container_header(buf, pos)
        end = pos + chdr["length"]
        blocks = []
        while pos < end:
            b, pos = decode_block(buf, pos)
            blocks.append(b)
        comp = next(b for b in blocks
                    if b["ctype"] == CT_COMPRESSION_HEADER)
        pres_raw, ds_raw, tag_raw = _parse_maps(comp["data"])
        # tag dictionary out of the preservation map
        tag_lines = [b""]
        p = 0
        cnt, p = itf8_decode(pres_raw, p)
        for _ in range(cnt):
            key = pres_raw[p:p + 2]
            p += 2
            if key == b"TD":
                tdl, p = itf8_decode(pres_raw, p)
                td = pres_raw[p:p + tdl]
                p += tdl
                tag_lines = td.split(b"\x00")[:-1]
            else:
                p += 1  # bool byte
        ext = {b["cid"]: b["data"] for b in blocks
               if b["ctype"] == CT_EXTERNAL}
        cursors = {k: 0 for k in list(CID.values()) + [CID_TAGS]}

        def take_itf8(cid):
            v, cursors[cid] = itf8_decode(ext[cid], cursors[cid])
            return v

        for _ in range(chdr["n_records"]):
            take_itf8(CID["BF"])
            cf = take_itf8(CID["CF"])
            rl = take_itf8(CID["RL"])
            take_itf8(CID["AP"])
            take_itf8(CID["RG"])
            rn_buf = ext[CID["RN"]]
            stop = rn_buf.index(0, cursors[CID["RN"]])
            read_id = rn_buf[cursors[CID["RN"]]:stop].decode()
            cursors[CID["RN"]] = stop + 1
            take_itf8(CID["MF"])
            take_itf8(CID["NS"])
            take_itf8(CID["NP"])
            take_itf8(CID["TS"])
            tl = take_itf8(CID["TL"])
            seq = ext[CID["BA"]][cursors[CID["BA"]]:
                                 cursors[CID["BA"]] + rl].decode()
            cursors[CID["BA"]] += rl
            if cf & 1:
                qraw = ext[CID["QS"]][cursors[CID["QS"]]:
                                      cursors[CID["QS"]] + rl]
                cursors[CID["QS"]] += rl
                qstring = "*" if qraw == b"\xff" * rl \
                    else "".join(chr(q + 33) for q in qraw)
            else:
                qstring = "*"
            tags = []
            line = tag_lines[tl] if tl < len(tag_lines) else b""
            for k in range(0, len(line), 3):
                tag = line[k:k + 2].decode()
                vtype = chr(line[k + 2])
                dlen, cursors[CID_TAGS] = itf8_decode(
                    ext[CID_TAGS], cursors[CID_TAGS])
                raw = ext[CID_TAGS][cursors[CID_TAGS]:
                                    cursors[CID_TAGS] + dlen]
                cursors[CID_TAGS] += dlen
                tags.append(f"{tag}:{vtype}:{_tag_value_str(vtype, raw)}")
            records.append({"read_id": read_id, "seq": seq,
                            "qstring": qstring, "tags": tags})
    return header_text, records
