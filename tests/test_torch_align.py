"""The port's host side of the bootstrap-data phase against the JAX
package: ``read_fasta``, ``align_read`` (the exhaustive scan, batched
through the native ``sw_score_batch`` or looped over ``sw_align``, both
strands, X/Y read against the templates' N, the seed index and its
rescue, a read below ``min_score``), ``align_fastq``, ``write_paf`` /
``read_paf``, ``parse_cs``, the SAM record and writer, ``typical_indices``
and ``CtcDataWriter``.  Every comparison is exact: the same records, the
same text, ``.npy`` files and ``filter_stats.csv`` equal byte for byte."""

import io
import os

import numpy as np
import pytest

from xna_basecaller_tpu.core.alphabet import reverse_complement_str
from xna_basecaller_tpu.data import writers as jwriters
from xna_basecaller_tpu.eval import cs_align as jcs_align
from xna_basecaller_tpu.eval import ref_align as jref_align
from xna_basecaller_tpu.eval import xna_refs as jxna_refs
from xna_basecaller_tpu.utils import native as jnative
from xna_basecaller_tpu_torch.data import writers
from xna_basecaller_tpu_torch.eval import (
    accuracy, cs_align, ref_align, xna_refs,
)
from xna_basecaller_tpu_torch.utils import native


def _mutate(rng, seq, n):
    s = list(seq)
    for i in rng.choice(len(s), size=n, replace=False):
        s[i] = "ACGT"[(("ACGT".index(s[i]) if s[i] in "ACGT" else 0)
                       + int(rng.integers(1, 4))) % 4]
    return "".join(s)


def _library(seed=0, n=6, length=120):
    """Templates with a UB (N) at a few positions, and reads: template
    fragments with X/Y at the N positions, mutated, on both strands, one
    heavily mutated (the seed path's rescue) and one of 5 bases (at most
    25 points: below min_score 30)."""
    rng = np.random.default_rng(seed)
    targets = {}
    for i in range(n):
        t = list("".join(rng.choice(list("ACGT"), size=length)))
        for p in rng.choice(np.arange(10, length - 10), size=2,
                            replace=False):
            t[p] = "N"
        targets[f"tpl{i}"] = "".join(t)
    reads = {}
    for i, (tid, t) in enumerate(targets.items()):
        frag = t[8 + i: length - 5]
        frag = "".join(rng.choice(["X", "Y"]) if c == "N" else c
                       for c in frag)
        frag = _mutate(rng, frag, 3)
        reads[f"r{i}"] = reverse_complement_str(frag) if i % 2 else frag
    # one exact 12-mer seed, then too many mutations for the seed path's
    # result to be trusted: the rescue's full scan runs
    base = targets["tpl0"].replace("N", "A")
    reads["noisy"] = base[:14] + _mutate(rng, base[14:], 40)
    reads["short"] = "".join(rng.choice(list("ACGT"), size=5))
    return targets, reads


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def maybe_native(request, monkeypatch):
    """Both packages with their native library, or both without it."""
    if not request.param:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "available", lambda: False)
    return request.param


def test_read_fasta_matches_jax(tmp_path):
    path = tmp_path / "ref.fasta"
    path.write_text(">a first template\nACGT\nNNAC\n\n>b\n\nTTGA\n>c x\n"
                    ">d\nACGTN")
    got = xna_refs.read_fasta(str(path))
    assert got == jxna_refs.read_fasta(str(path))
    assert got == {"a": "ACGTNNAC", "b": "TTGA", "c": "", "d": "ACGTN"}


@pytest.mark.parametrize("n_templates", [6, 3], ids=["batched", "looped"])
def test_align_read_matches_jax(n_templates, maybe_native):
    """Six templates give 12 (strand, template) pairs, which go through
    the batched score pass when the library is there; three give 6,
    which are looped."""
    targets, reads = _library(n=n_templates)
    got = {}
    for rid, seq in reads.items():
        rec = ref_align.align_read(rid, seq, targets)
        want = jref_align.align_read(rid, seq, targets)
        assert (rec is None) == (want is None), rid
        got[rid] = rec
        if rec is not None:
            assert rec.as_dict() == want.as_dict(), rid
    assert got["short"] is None
    assert {got[f"r{i}"].strand for i in range(n_templates)} == {"+", "-"}
    assert all(got[f"r{i}"].target_id == f"tpl{i}"
               for i in range(n_templates))


def test_align_read_seed_path_and_rescue_match_jax(maybe_native):
    targets, reads = _library(n=6)
    index = ref_align.SeedIndex(targets)
    jindex = jref_align.SeedIndex(targets)
    assert index.index == jindex.index
    for rid, seq in reads.items():
        seq_n = seq.replace("X", "N").replace("Y", "N")
        assert index.candidates(seq_n) == jindex.candidates(seq_n)
        rec = ref_align.align_read(rid, seq, targets, seed_index=index)
        want = jref_align.align_read(rid, seq, targets, seed_index=jindex)
        assert (rec is None) == (want is None), rid
        if rec is not None:
            assert rec.as_dict() == want.as_dict(), rid
    # the noisy read has a seed hit, and its best candidate scores below
    # the rescue threshold: the full scan runs
    noisy = reads["noisy"]
    assert index.candidates(noisy) == [("tpl0", "+")]
    assert accuracy.sw_align(noisy, targets["tpl0"])[0] \
        < 0.45 * 5 * min(len(noisy), len(targets["tpl0"]))
    rec = ref_align.align_read("noisy", noisy, targets, seed_index=index)
    assert rec.target_id == "tpl0"


@pytest.mark.parametrize("opts", [{}, {"use_seeds": True},
                                  {"n_proc": 2}], ids=["scan", "seeds",
                                                       "pool"])
def test_align_fastq_and_paf_match_jax(opts, tmp_path):
    targets, reads = _library(seed=1)
    recs = ref_align.align_fastq(reads, targets, **opts)
    want = jref_align.align_fastq(reads, targets, **opts)
    assert recs == want and len(recs) == len(reads) - 1
    ref_align.write_paf(recs, str(tmp_path / "port.paf"))
    jref_align.write_paf(want, str(tmp_path / "jax.paf"))
    assert (tmp_path / "port.paf").read_bytes() \
        == (tmp_path / "jax.paf").read_bytes()
    back = ref_align.read_paf(str(tmp_path / "port.paf"))
    assert back == jref_align.read_paf(str(tmp_path / "jax.paf"))
    assert [r["cs"] for r in back] == [r["cs"] for r in recs]


@pytest.mark.parametrize("cs", [":12*ag:3+ac-t:7", "", ":5~gt12ag:3",
                                "=ACGT*nx-nn:2"])
def test_parse_cs_matches_jax(cs):
    assert cs_align.parse_cs(cs) == jcs_align.parse_cs(cs)


def _mappings():
    targets, reads = _library(seed=2)
    out = [(rid, seq, jref_align.align_read(rid, seq, targets))
           for rid, seq in reads.items()]
    return targets, [(rid, seq, None if r is None else r.as_dict())
                     for rid, seq, r in out]


def test_sam_record_fields_match_jax():
    _, mapped = _mappings()
    strands = set()
    for rid, seq, mapping in mapped:
        q = "O" * len(seq)
        got = writers.sam_record_fields(rid, seq, q, mapping)
        assert got == jwriters.sam_record_fields(rid, seq, q, mapping)
        strands.add(got[1])
    assert strands == {"0", "4", "16"}
    assert writers._cigar_from_cs(":3*ag+c-tt:2") \
        == jwriters._cigar_from_cs(":3*ag+c-tt:2") == "4M1I2D2M"


@pytest.mark.parametrize("read_group", [None, "model_x"])
def test_sam_writer_text_matches_jax(read_group):
    targets, mapped = _mappings()
    got, want = io.StringIO(), io.StringIO()
    w = writers.SamWriter(got, targets, read_group=read_group)
    jw = jwriters.SamWriter(want, targets, read_group=read_group)
    for i, (rid, seq, mapping) in enumerate(mapped):
        tags = ["XX:i:1"] if i % 2 else None
        w.write(rid, seq, "O" * len(seq), mapping, tags=tags)
        jw.write(rid, seq, "O" * len(seq), mapping, tags=tags)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().count("\n") == 2 + len(targets) + len(mapped) \
        + (read_group is not None)


@pytest.mark.parametrize("x", [[5, 5, 5], [1, 40, 41, 42, 43, 44, 45, 200],
                               np.arange(30) ** 2])
def test_typical_indices_match_jax(x):
    np.testing.assert_array_equal(writers.typical_indices(x),
                                  jwriters.typical_indices(x))


def _ctc_adds(seed=3):
    """An add sequence through every branch of CtcDataWriter.add: an empty
    call, no mapping, a template span without N, accuracy and coverage
    failing alone and together, and kept chunks on both strands."""
    rng = np.random.default_rng(seed)
    adds = [("", None, None), ("ACGT", None, None)]
    for i in range(24):
        L = int(rng.integers(30, 60))
        refseq = "".join(rng.choice(list("ACGT"), size=L))
        if i % 3:
            p = int(rng.integers(1, L - 1))
            refseq = refseq[:p] + "N" + refseq[p + 1:]
        seq = "".join(rng.choice(list("ACGTXY"), size=L))
        strand = "+-"[i % 2]
        kind = i % 8
        mapping = {"strand": strand, "read_start": 0, "read_end": L,
                   "n_matches": L, "alignment_block_length": L}
        if kind == 5:
            mapping["n_matches"] = int(0.9 * L)      # accuracy fails
        elif kind == 6:
            mapping["read_end"] = int(0.8 * L)       # coverage fails
        elif kind == 7:
            mapping.update(n_matches=int(0.9 * L), read_end=int(0.8 * L))
        adds.append((seq, mapping, refseq))
    return adds


@pytest.mark.parametrize("ub_only", [False, True])
def test_ctc_writer_files_equal_jax(ub_only, tmp_path):
    rng = np.random.default_rng(4)
    w = writers.CtcDataWriter(str(tmp_path / "port"), ub_only=ub_only,
                              log=lambda *a: None)
    jw = jwriters.CtcDataWriter(str(tmp_path / "jax"), ub_only=ub_only,
                                log=lambda *a: None)
    for seq, mapping, refseq in _ctc_adds():
        signal = rng.normal(size=400).astype(np.float32)
        assert w.add(signal, seq, mapping, refseq=refseq) \
            == jw.add(signal, seq, mapping, refseq=refseq)
    assert w.stats == jw.stats
    assert all(v > 0 for k, v in w.stats.items()
               if k != "non_ubs_skipped" or ub_only)
    n = w.save()
    assert n == jw.save() > 0
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "chunks.npy", "filter_stats.csv", "reference_lengths.npy",
        "references.npy"]
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() \
            == (tmp_path / "jax" / f).read_bytes(), f
    refs = np.load(tmp_path / "port" / "references.npy")
    # strand-aware UB codes: N is 5 on '+', 6 on '-'
    assert {5, 6} <= set(np.unique(refs).tolist()) <= {0, 1, 2, 3, 4, 5, 6}
    if ub_only:
        assert ((refs == 5) | (refs == 6)).any(axis=1).all()


def test_ctc_writer_without_chunks_writes_nothing(tmp_path):
    logged = []
    w = writers.CtcDataWriter(str(tmp_path / "d"), log=logged.append)
    assert w.add(np.zeros(10), "", None) is False
    assert w.save() == 0 and not (tmp_path / "d").exists()
    assert logged == ["> no suitable ctc data to write"]
