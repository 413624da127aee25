"""The port's CRAM 3.0 codec (``data/cram.py``) against the JAX package's:
the varints and blocks byte-equal, the spec's EOF container reproduced by
the serializer, every file byte-equal to JAX's on the same records (one
and several containers, read groups, typed tags, reads without
qualities; gzip blocks carry the clock's time, so both writers run with
it pinned), and ``read_cram`` round trips equal to JAX's and to the
records written."""

import time

import numpy as np
import pytest

from xna_basecaller_tpu.data import cram as jcram
from xna_basecaller_tpu_torch.data import cram as tcram


@pytest.mark.parametrize("v", [0, 1, 0x7F, 0x80, 0x3FFF, 0x4000, 0x1FFFFF,
                               0x200000, 0x0FFFFFFF, 0x10000000, 0xFFFFFFFF,
                               4542278])
def test_itf8_matches_jax(v):
    enc = tcram.itf8_encode(v)
    assert enc == jcram.itf8_encode(v)
    assert tcram.itf8_decode(enc, 0) == (v, len(enc))


@pytest.mark.parametrize("v", [0, 0x80, 1 << 20, 1 << 34, 1 << 55,
                               (1 << 60) + 12345])
def test_ltf8_matches_jax(v):
    enc = tcram.ltf8_encode(v)
    assert enc == jcram.ltf8_encode(v)
    assert tcram.ltf8_decode(enc, 0) == (v, len(enc))


def test_eof_container_is_the_spec_constant():
    assert tcram.EOF_BYTES == jcram.EOF_BYTES
    assert tcram.eof_container() == tcram.EOF_BYTES


def test_block_crc_detects_corruption():
    blk = bytearray(tcram.encode_block(tcram.CT_EXTERNAL, 1, b"hello"))
    assert bytes(blk) == jcram.encode_block(jcram.CT_EXTERNAL, 1, b"hello")
    blk[6] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        tcram.decode_block(bytes(blk), 0)


def records(n):
    rng = np.random.default_rng(n)
    out = []
    for i in range(n):
        k = int(rng.integers(5, 300))
        seq = "".join(rng.choice(list("ACGTXY"), size=k))
        qual = "".join(chr(33 + int(x)) for x in rng.integers(0, 45, size=k))
        tags = [None, ["mx:Z:1", "ch:Z:7"],
                ["mv:B:c,5,1,0,1", "qs:i:-42", "du:f:1.5", "st:A:+"]][i % 3]
        out.append((f"read_{i}", seq, "*" if i % 7 == 6 else qual, None,
                    tags))
    return out


@pytest.mark.parametrize("n,per_container", [(1, 8192), (25, 8192),
                                             (37, 10)])
@pytest.mark.parametrize("read_group", [None, "grp1"])
def test_cram_file_matches_jax(tmp_path, monkeypatch, n, per_container,
                               read_group):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    targets = {"tpl1": "A" * 100, "tpl2": "C" * 7}
    paths = []
    for mod in (jcram, tcram):
        path = str(tmp_path / f"{mod.__name__}.cram")
        w = mod.CramWriter(path, targets, read_group=read_group,
                           records_per_container=per_container)
        for rec in records(n):
            w.write(*rec)
        w.close()
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert b.read() == a.read()
    header, got = tcram.read_cram(paths[1])
    assert (header, got) == jcram.read_cram(paths[0])
    assert "@SQ\tSN:tpl1\tLN:100" in header
    assert [(r["read_id"], r["seq"], r["qstring"]) for r in got] == [
        (rid, seq, q) for rid, seq, q, _, _ in records(n)]
    rg = [f"RG:Z:{read_group}"] if read_group else []
    assert [r["tags"] for r in got] == [rg + (t or [])
                                        for *_, t in records(n)]
