"""The port's template libraries (``eval/xna_refs.py`` over its own copy of
``assets/xna_libs``), its ``cs_align`` and its ``lev_demux`` and
``sw_align_banded`` bindings against the JAX package's: every attribute,
record and result equal (exact: strings, positions, integer scores and
distances, float metrics computed by the same operations)."""

import numpy as np
import pytest

from xna_basecaller_tpu.eval import cs_align as jcs
from xna_basecaller_tpu.eval import xna_refs as jrefs
from xna_basecaller_tpu.utils import native as jnative
from xna_basecaller_tpu_torch.eval import cs_align as cs
from xna_basecaller_tpu_torch.eval import xna_refs
from xna_basecaller_tpu_torch.utils import native

ATTRS = ("ref_name", "barcode_len", "left_primer_len", "middle_primer_len",
         "right_primer_len", "left_primer", "targets", "barcodes",
         "barcodes_pos", "xna_kmers", "xna_kmers_pos", "xna_kmers_len",
         "x_pos", "x_pos_rev", "len_targets", "targets_id",
         "xna_targets_id", "pc_targets_id", "barcodes_cnt")


def _nan_equal(a, b):
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_nan_equal, a, b))
    return a == b


def test_assets_are_the_ports_own_copy():
    assert xna_refs.ASSETS_LIBS != jrefs.ASSETS_LIBS
    assert "xna_basecaller_tpu_torch" in xna_refs.ASSETS_LIBS
    for lib in ("POC", "CPLX", "XNA16", "XNA_4Ds"):
        for name in ("refdb_short.fasta",):
            with open(f"{xna_refs.ASSETS_LIBS}/{lib}/{name}", "rb") as a, \
                    open(f"{jrefs.ASSETS_LIBS}/{lib}/{name}", "rb") as b:
                assert a.read() == b.read()


@pytest.mark.parametrize("name", ["POC", "CPLX", "XNA16", "XNA_4Ds"])
@pytest.mark.parametrize("aliases", [False, True])
def test_xna_refs_equal_jax(name, aliases):
    got = xna_refs.XnaRefs(name, use_aliases=aliases)
    want = jrefs.XnaRefs(name, use_aliases=aliases)
    for attr in ATTRS:
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.full_targets == want.full_targets
    assert got.insert_span == want.insert_span
    tid = got.xna_targets_id[0]
    assert got.full_ub_positions(tid) == want.full_ub_positions(tid)
    for t in got.targets_id[:6]:
        assert got.get_ub_kmers(t) == want.get_ub_kmers(t)
        assert got.get_ub_kmers(t, reverse=True) == \
            want.get_ub_kmers(t, reverse=True)
        assert got.get_complement_target_id(t) == \
            want.get_complement_target_id(t)
        for strand in "FR":
            assert got.locate_read(30, 54, t, strand, 500) == \
                want.locate_read(30, 54, t, strand, 500)


@pytest.mark.parametrize("ids", [["XNA1"], ["PC15", "nothing"], ["nothing"],
                                 ["84Ds4-AA"], ["XNA1024_0001"]])
def test_identify_ref_equal_jax(ids):
    cplx = jrefs.XnaRefs("CPLX").targets_id[3]
    ids = [cplx if i == "XNA1024_0001" else i for i in ids]
    got, want = xna_refs.identify_ref(ids), jrefs.identify_ref(ids)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.ref_name == want.ref_name
        assert got.targets_id == want.targets_id


def _mutated(rng, seq, rate=0.06):
    out = []
    for ch in seq:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            ch = "ACGT"[rng.integers(4)]
        out.append(ch)
        if rng.random() < rate / 3:
            out.append("ACGTX"[rng.integers(5)])
    return "".join(out)


@pytest.mark.parametrize("seed", range(4))
def test_lev_demux_and_banded_sw_equal_jax(seed):
    rng = np.random.default_rng(seed)
    refs = xna_refs.XnaRefs("POC")
    cands = [refs.targets[t][20:60] for t in refs.targets_id]
    query = _mutated(rng, cands[int(rng.integers(len(cands)))])
    assert native.lev_demux(query, cands) == jnative.lev_demux(query, cands)
    target = refs.targets[refs.targets_id[seed]]
    read = _mutated(rng, target[10:-10])
    for dlo, dhi in ((-5, 25), (0, 10), (-40, 40), (30, 60)):
        assert native.sw_align_banded(read, target, dlo, dhi) == \
            jnative.sw_align_banded(read, target, dlo, dhi)


def test_bindings_without_the_library(monkeypatch):
    """No native library: both bindings return None, as JAX's do, and the
    callers take their pure-Python paths."""
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.lev_demux("ACGT", ["ACGA"]) is None
    assert native.sw_align_banded("ACGT", "ACGT", -2, 2) is None


def _record(rng, refs, tid, strand):
    """A read of template ``tid`` with errors, flanked, and its alignment
    by the JAX aligner (the records both packages' functions take)."""
    from xna_basecaller_tpu.core.alphabet import reverse_complement_str
    from xna_basecaller_tpu.eval.ref_align import align_read

    tar = refs.targets[tid].replace("N", "X")
    base = tar if strand == "F" else reverse_complement_str(tar)
    seq = ("".join("ACGT"[i] for i in rng.integers(0, 4, 20))
           + _mutated(rng, base) + "".join("ACGT"[i]
                                           for i in rng.integers(0, 4, 20)))
    rec = align_read("r", seq, refs.targets).as_dict()
    return rec, seq


@pytest.mark.parametrize("seed", range(6))
def test_cs_align_functions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    refs = jrefs.XnaRefs("POC")
    tid = refs.targets_id[int(rng.integers(len(refs.targets_id)))]
    rec, seq = _record(rng, refs, tid, "FR"[seed % 2])
    target = refs.targets[tid]
    ops = cs.parse_cs(rec["cs"])
    assert ops == jcs.parse_cs(rec["cs"])
    args = (target, ops, rec["target_start"], rec["target_end"])
    np.testing.assert_array_equal(cs.compute_target_matches(*args),
                                  jcs.compute_target_matches(*args))
    sub = seq[rec["read_start"]:rec["read_end"]]
    if rec["strand"] == "-":
        from xna_basecaller_tpu_torch.core.alphabet import (
            reverse_complement_str)
        sub = reverse_complement_str(sub)
    args = (sub, ops, rec["target_start"], rec["target_end"],
            rec["target_length"])
    np.testing.assert_array_equal(cs.compute_read_matches(*args),
                                  jcs.compute_read_matches(*args))
    assert cs.aligned_pair(rec, target, sub) == \
        jcs.aligned_pair(rec, target, sub)
    xt = target.replace("N", "X")
    tm = jcs.compute_read_matches(*args)
    np.testing.assert_array_equal(cs.polish_target_matches(tm, xt),
                                  jcs.polish_target_matches(tm, xt))
    for polish in (False, True):
        for read_seq in (None, sub):
            for ignore_n in (False, True):
                e1, t1 = cs.compute_errors(rec, xt, read_seq, polish,
                                           ignore_n)
                e2, t2 = jcs.compute_errors(rec, xt, read_seq, polish,
                                            ignore_n)
                np.testing.assert_array_equal(e1, e2)
                np.testing.assert_array_equal(t1, t2)
    errors, tm = jcs.compute_errors(rec, xt, sub)
    got, want = cs.ub_metrics(errors, tm, xt, rec), \
        jcs.ub_metrics(errors, tm, xt, rec)
    assert list(got) == list(want)
    assert all(_nan_equal(got[k], want[k]) for k in want)
    for n_relax in (0, 3):
        assert cs.barcode_match(rec, seq, refs.left_primer_len,
                                refs.barcodes[tid], n_relax) == \
            jcs.barcode_match(rec, seq, refs.left_primer_len,
                              refs.barcodes[tid], n_relax)
    a, b = seq[:40], target[:50]
    assert cs.levenshtein(a, b) == jcs.levenshtein(a, b)


def test_levenshtein_pure_python_equals_jax(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "available", lambda: False)
    rng = np.random.default_rng(7)
    for _ in range(5):
        a = "".join("ACGTX"[i] for i in rng.integers(0, 5, 30))
        b = _mutated(rng, a, 0.3)
        assert cs.levenshtein(a, b) == jcs.levenshtein(a, b)
