"""The port's ``analyze_paf`` (numpy and the ``csv`` module, no pandas or
sklearn) against the JAX package's (pandas) on reads of the POC library
mutated as ``tests/test_golden_analyze.py::_mutate`` does: the summary
dict equal, and every file it writes byte-equal (the CSVs: header, rows,
strings and the numbers as pandas formats them; the confusion matrix,
equal to ``sklearn.metrics.confusion_matrix``'s; the missing-template
list).  ``eval/table.py``'s means follow pandas' order of operations, so
the numbers are the same bits before they are formatted."""

import filecmp
import os

import numpy as np
import pytest

from xna_basecaller_tpu.core.alphabet import reverse_complement_str
from xna_basecaller_tpu.eval import analyze as janalyze
from xna_basecaller_tpu.eval import ref_align as jref_align
from xna_basecaller_tpu.eval.xna_refs import XnaRefs as JXnaRefs
from xna_basecaller_tpu_torch.eval import analyze, table
from xna_basecaller_tpu_torch.eval.xna_refs import XnaRefs


def _mutate(seq: str, ub_char: str, rng) -> str:
    """Controlled sequencing errors: substitutions, indels, UB misses and
    false UB calls (tests/test_golden_analyze.py::_mutate)."""
    out = []
    bases = "ACGT"
    for ch in seq:
        r = rng.random()
        if r < 0.015:  # deletion
            continue
        if ch in "XY":
            if rng.random() < 0.15:  # UB miss
                ch = bases[rng.integers(4)]
        else:
            r2 = rng.random()
            if r2 < 0.04:  # substitution
                ch = bases[(bases.index(ch) + 1 + rng.integers(3)) % 4]
            elif r2 < 0.045:  # false UB call
                ch = ub_char
        out.append(ch)
        if rng.random() < 0.015:  # insertion
            out.append(bases[rng.integers(4)])
    return "".join(out)


@pytest.fixture(scope="module")
def fixture():
    """1-UB (XNA16), multi-UB (XNA_4Ds) and PC templates, both strands,
    three reads each (as the golden test builds them), plus two reads of a
    wrong barcode; their alignments by the JAX aligner; per-base
    qualities from a seed."""
    refs = JXnaRefs("POC")
    rng = np.random.default_rng(42)
    tids = (refs.xna_targets_id[:3] + refs.xna_targets_id[12:14]
            + refs.xna_targets_id[16:18] + refs.pc_targets_id[:2])
    reads = {}
    for tid in tids:
        tar = refs.targets[tid].replace("N", "X")
        for strand in "FR":
            base = tar if strand == "F" else reverse_complement_str(tar)
            ub_char = "X" if strand == "F" else "Y"
            for i in range(3):
                flank_l = "".join("ACGT"[j] for j in rng.integers(0, 4, 30))
                flank_r = "".join("ACGT"[j] for j in rng.integers(0, 4, 30))
                reads[f"{tid}_{strand}_{i}"] = (
                    flank_l + _mutate(base, ub_char, rng) + flank_r)
    records = jref_align.align_fastq(reads, refs.targets)
    quals = {rid: rng.integers(2, 40, len(seq))
             for rid, seq in reads.items()}
    return records, reads, quals


CASES = {
    "demux": dict(max_bc_dist=5, save_perf_per_read=True),
    "no demux": dict(save_perf_per_read=True),
    "strand X, min reads": dict(ubs="X", min_reads_count=2,
                                save_perf_per_read=True),
    "lists": dict(max_bc_dist=8, targets_list="half",
                  include_list="most", min_reads_count=3),
    "quals and confusion": dict(max_bc_dist=5, q_scores=True,
                                save_confusion_matrix=True,
                                save_perf_per_read=True),
    "oracle": dict(max_bc_dist=1, oracle_demux=True,
                   save_perf_per_read=True),
    "oracle, no demux": dict(oracle_demux=True),
    "max dist 6, no polish": dict(max_dist=6, polish=False,
                                  save_detailed_perf=False),
}


def _nan_equal(a, b):
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return a == b and type(a) is type(b) or (
        isinstance(a, (int, float)) and not isinstance(a, bool)
        and a == b)


@pytest.mark.parametrize("case", list(CASES))
def test_analyze_paf_equals_jax(tmp_path, fixture, case):
    records, reads, quals = fixture
    kw = dict(CASES[case])
    refs = JXnaRefs("POC")
    if kw.pop("q_scores", False):
        kw["read_quals"] = quals
    if kw.get("targets_list") == "half":
        kw["targets_list"] = refs.targets_id[::2]
    if kw.get("include_list") == "most":
        kw["include_list"] = [r for i, r in enumerate(reads) if i % 5]
    outs = {}
    for name, mod, lib in (("jax", janalyze, JXnaRefs),
                           ("port", analyze, XnaRefs)):
        out = tmp_path / name
        outs[name] = (out, mod.analyze_paf(
            "POC", [dict(r) for r in records], dict(reads),
            out_dir=str(out), refs=lib("POC"), log=lambda *a: None, **kw))
    (jdir, want), (pdir, got) = outs["jax"], outs["port"]
    assert list(got) == list(want)
    for k in want:
        assert _nan_equal(got[k], want[k]), (k, got[k], want[k])
    files = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == files
    assert any(f.endswith(".csv") for f in files)
    for f in files:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pdir / f),
                                          np.load(jdir / f))
        else:
            assert filecmp.cmp(pdir / f, jdir / f, shallow=False), (
                f, (pdir / f).read_text()[:2000],
                (jdir / f).read_text()[:2000])


def test_the_cases_write_every_file(tmp_path, fixture):
    """The case list reaches every file analyze_paf writes."""
    records, reads, quals = fixture
    analyze.analyze_paf("POC", records, reads, out_dir=str(tmp_path),
                        max_bc_dist=5, min_reads_count=3, read_quals=quals,
                        save_confusion_matrix=True, save_perf_per_read=True,
                        log=lambda *a: None)
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"results_summ{s}" for s in (
            ".csv", "-by_tar.csv", "-by_tar_pos.csv", "-per_read.csv",
            "-confusion_matrix.npy", "-missing_templates.txt"))


@pytest.mark.parametrize("seed", range(3))
def test_confusion_matrix_equals_sklearn(seed):
    from sklearn.metrics import confusion_matrix

    rng = np.random.default_rng(seed)
    labels = list(analyze.CONFUSION_LABELS)
    y_true = list(rng.choice(list("ATCGXYN-"), 200))
    y_pred = list(rng.choice(list("ATCGXY-*"), 200))
    np.testing.assert_array_equal(
        analyze.confusion_matrix(y_true, y_pred, labels),
        confusion_matrix(y_true, y_pred, labels=labels))
    with pytest.raises(ValueError):
        analyze.confusion_matrix(["N"], ["A"], labels)
    with pytest.raises(ValueError):
        confusion_matrix(["N"], ["A"], labels=labels)


def test_table_means_and_dtypes_follow_pandas():
    import pandas as pd

    rng = np.random.default_rng(3)
    for n in (1, 7, 300):
        v = rng.normal(size=n) * 10.0 ** rng.integers(-3, 12, size=n)
        v[::4] = np.nan
        assert _nan_equal(table.series_mean(v), float(pd.Series(v).mean()))
        df = pd.DataFrame({"g": ["a"] * n, "x": v})
        assert _nan_equal(table.group_mean(v),
                          float(df.groupby("g")["x"].mean().iloc[0]))
    rows = [{"a": 1, "b": 1.5, "c": "x", "d": True, "e": 2},
            {"a": 2, "b": None, "c": None, "d": False, "e": np.inf},
            {"a": 3, "c": "z", "d": True, "e": 3}]
    t, df = table.Table.from_records(rows), pd.DataFrame(rows)
    for col in df:
        assert t[col].dtype.kind == df[col].dtype.kind or (
            t[col].dtype == object and df[col].dtype.kind in "OT"), col
