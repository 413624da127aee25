"""The port's BGZF/BAM codec (``data/bam.py``) against the JAX package's:
the BGZF blocks and every BAM file byte-equal to JAX's on the same records
(the XNA letters X/Y folded to N, as JAX folds them; both strands,
unmapped records, tags, read groups, several BGZF blocks), ``read_bam``
round trips equal to JAX's, and ``read_sam`` on SAM and BAM giving JAX's
DataFrame column by column (names, order, dtype kinds, values; NaN where
pandas divides 0 by 0) as an ``eval/table.py`` Table, and
``sam_to_paf_records`` JAX's records."""

import io

import numpy as np
import pytest

from xna_basecaller_tpu.data import bam as jbam
from xna_basecaller_tpu.data.writers import SamWriter as JSamWriter
from xna_basecaller_tpu_torch.data import bam as tbam
from xna_basecaller_tpu_torch.data.writers import SamWriter

MAPPING = dict(
    target_id="T1", target_start=5, target_end=25, strand="+",
    read_start=2, read_end=22, read_length=24, mapping_quality=60,
    n_matches=19, alignment_block_length=20, target_cover=0.9,
    percent_match=0.95, cs=":10*at:9")


@pytest.fixture(scope="module")
def targets():
    rng = np.random.default_rng(1)
    return {name: "".join(rng.choice(list("ACGT"), 40))
            for name in ("T1", "PC_2")}


def records(n=6):
    """Mapped on both strands and to the PC template, unmapped, with X/Y,
    without qualities, with tags."""
    rng = np.random.default_rng(n)
    out = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGTXY"), 24))
        qual = "".join(chr(33 + q) for q in rng.integers(0, 40, 24))
        mapping = [MAPPING, dict(MAPPING, strand="-"),
                   dict(MAPPING, target_id="PC_2", target_start=0,
                        mapping_quality=7), None][i % 4]
        tags = [["qs:i:17", "mx:f:0.5"], None, ["ZZ:Z:abc"], None][i % 4]
        out.append((f"read{i}", seq, "" if i % 5 == 4 else qual, mapping,
                    tags))
    return out


def test_bgzf_matches_jax():
    payload = np.random.default_rng(0).integers(
        0, 256, size=200_000, dtype=np.uint8).tobytes()
    bufs = []
    for mod in (jbam, tbam):
        buf = io.BytesIO()
        w = mod.BgzfWriter(buf)
        for start in range(0, len(payload), 70_001):
            w.write(payload[start:start + 70_001])
        w.close()
        bufs.append(buf.getvalue())
    assert bufs[1] == bufs[0]
    assert bufs[1].endswith(tbam.BGZF_EOF)
    import gzip
    assert gzip.decompress(bufs[1]) == payload


@pytest.mark.parametrize("read_group", [None, "grp_1"])
@pytest.mark.parametrize("n", [1, 6, 3000])
def test_bam_file_matches_jax(tmp_path, targets, read_group, n):
    """3000 records span several 65280-byte BGZF blocks."""
    paths = []
    for mod in (jbam, tbam):
        path = str(tmp_path / f"{mod.__name__}.bam")
        w = mod.BamWriter(path, targets, read_group=read_group)
        for rid, seq, qual, mapping, tags in records(n):
            w.write(rid, seq, qual, mapping, tags=tags)
        w.close()
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert b.read() == a.read()
    got, want = tbam.read_bam(paths[1]), jbam.read_bam(paths[0])
    assert got == want
    refs, recs = got
    assert refs == [("T1", 40), ("PC_2", 40)] and len(recs) == n
    assert all(set(r["seq"]) <= set("ACGTN") for r in recs)


@pytest.mark.parametrize("fields", [
    ["r", "0", "T1", "6", "60", "2S20M2S", "*", "0", "0", "ACGTXY", "IIIIII"],
    ["r", "16", "PC_2", "1", "3", "5M1I3M2D4M", "*", "0", "0", "ACGTACGTACGTA",
     "*"],
    ["r", "4", "*", "0", "0", "*", "*", "0", "0", "ACG", "*"],
    ["r", "4", "*", "0", "0", "*", "*", "0", "0", "*", "*"]])
def test_encode_bam_record_matches_jax(fields):
    ref_ids = {"T1": 0, "PC_2": 1}
    tags = ["RG:Z:x", "qs:i:-3", "mx:f:1.5", "ch:A:c"]
    assert tbam.encode_bam_record(fields, ref_ids, tags) \
        == jbam.encode_bam_record(fields, ref_ids, tags)


def _write_both(tmp_path, targets, recs):
    sam_path = tmp_path / "out.sam"
    bam_path = str(tmp_path / "out.bam")
    with open(sam_path, "w") as fh:
        sw = SamWriter(fh, targets)
        bw = tbam.BamWriter(bam_path, targets)
        for w in (sw, bw):
            for rid, seq, qual, mapping, _ in recs:
                w.write(rid, seq, qual, mapping)
        bw.close()
    return str(sam_path), bam_path


@pytest.mark.parametrize("kind", ["sam", "bam"])
def test_read_sam_matches_jax_dataframe(tmp_path, targets, kind):
    """Every column of JAX's DataFrame: the same names in the same order,
    the same dtype kind (object, int64, float64, bool) and the same values
    (NaN for the unmapped records' target cover, as pandas gives 0/0)."""
    paths = dict(zip(("sam", "bam"), _write_both(tmp_path, targets,
                                                 records(8))))
    want = jbam.read_sam(paths[kind])
    got = tbam.read_sam(paths[kind], verbose=True)
    assert got.columns == list(want.columns)
    assert len(got) == len(want) == 8
    for col in want.columns:
        w = want[col].to_numpy()
        g = got[col]
        assert g.dtype.kind == w.dtype.kind, col
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(g, w, err_msg=col)
            assert np.isnan(g).any() == (col == "target_cover")
        else:
            assert g.tolist() == w.tolist(), col
    assert set(got["type"].tolist()) == {"PC", "XNA"}


@pytest.mark.parametrize("kind", ["sam", "bam"])
def test_sam_to_paf_records_match_jax(tmp_path, targets, kind):
    paths = dict(zip(("sam", "bam"), _write_both(
        tmp_path, targets, [r for r in records(8) if r[3] is not None])))
    got = tbam.sam_to_paf_records(paths[kind])
    want = jbam.sam_to_paf_records(paths[kind])
    assert got == want and len(got) == 6
    assert all(type(g[k]) is type(w[k]) for g, w in zip(got, want) for k in g)


def test_read_sam_of_no_records(tmp_path, targets):
    with open(tmp_path / "empty.sam", "w") as fh:
        JSamWriter(fh, targets)
    assert len(jbam.read_sam(str(tmp_path / "empty.sam"))) == 0
    table = tbam.read_sam(str(tmp_path / "empty.sam"))
    assert len(table) == 0 and table.empty


def test_read_bam_refuses_other_files(tmp_path):
    import gzip
    with gzip.open(tmp_path / "x.bam", "wb") as fh:
        fh.write(b"NOTBAM")
    with pytest.raises(ValueError, match="not a BAM file"):
        tbam.read_bam(str(tmp_path / "x.bam"))
