"""The port's ``eval/forensics.py`` and ``tools/comp_basecalls_perf.py``
(numpy and ``csv`` through ``eval/table.py``) against the JAX package's
(pandas), on the CPU, case by case as ``tests/test_forensics.py`` and
``test_tools.py::test_comp_basecalls_perf`` hold JAX's.

Each table is compared whole: column names in order, dtypes (pandas'
``str`` dtype as numpy's object), values (NaN where pandas has NaN; floats
exact, pandas' order of operations being kept) and row labels (pandas'
default index as the row numbers).  ``filter_demux``'s ``.csv.gz`` is
compared decompressed (the gzip header carries a time), and
``comp_basecalls_perf``'s printed view and CSV as text.  Inputs are made
from numpy seeds and written with pandas, then read by each package's
reader; where a function takes a table, each package gets its own read of
the same file.
"""

import gzip

import numpy as np
import pandas as pd
import pytest

from xna_basecaller_tpu.eval import forensics as jfx
from xna_basecaller_tpu.tools.comp_basecalls_perf import (
    comp_basecalls_perf as jcomp,
)
from xna_basecaller_tpu_torch.eval import forensics as fx
from xna_basecaller_tpu_torch.eval.table import Table, read_csv
from xna_basecaller_tpu_torch.tools.comp_basecalls_perf import (
    comp_basecalls_perf as tcomp,
)


def _kind(dtype) -> str:
    return "O" if isinstance(dtype, pd.StringDtype) or dtype == object \
        else np.dtype(dtype).kind


def assert_same(got: Table, want: pd.DataFrame):
    """The port's table equals JAX's frame: names, dtypes, values, rows."""
    assert got.columns == [str(c) for c in want.columns]
    for name in want.columns:
        w, g = want[name], got[name]
        assert g.dtype.kind == _kind(w.dtype), (name, g.dtype, w.dtype)
        assert len(g) == len(w)
        wv = w.to_numpy(dtype=object, na_value=np.nan)
        for a, b in zip(g.tolist(), wv.tolist()):
            if isinstance(b, float) and np.isnan(b):
                assert isinstance(a, float) and np.isnan(a), (name, a, b)
            else:
                assert a == b, (name, a, b)
    labels = got.index if got.index is not None else list(range(len(got)))
    assert list(labels) == want.index.tolist()


def _table(df: pd.DataFrame) -> Table:
    """A frame as the port's table: the same columns, dtypes and labels."""
    cols = {}
    for name in df.columns:
        if _kind(df[name].dtype) == "O":
            cols[name] = df[name].to_numpy(dtype=object, na_value=np.nan)
        else:
            cols[name] = df[name].to_numpy()
    return Table(cols, index=df.index.tolist())


def _eventalign_df():
    # two reads over a tiny target, nanopolish-style columns
    rows = []
    for read in ("r1", "r2"):
        for pos, kmer in [(0, "ACGTAC"), (1, "CGTACG"), (2, "GTACGT")]:
            rows.append(dict(
                target_id="T1", position=pos, reference_kmer=kmer,
                read_id=read, event_index=float(pos),
                model_kmer=kmer, samples="1.0,2.0,3.0"))
    return pd.DataFrame(rows)


def _write_eventalign(tmp_path, df, name="ev.tsv"):
    p = tmp_path / name
    df.rename(columns={"target_id": "contig", "read_id": "read_name"}
              ).to_csv(p, sep="\t")   # with pandas' index: "Unnamed: 0"
    return str(p)


def _polished_eventalign():
    """Rows whose polished (NaN event_index) UB k-mers were written
    reverse-complemented, among seeded signal samples."""
    rng = np.random.default_rng(3)
    rows = []
    for read in ("r2", "r1"):
        for pos, kmer, ev in [(0, "GTNCGT", np.nan), (1, "AGTNCG", 1.0),
                              (2, "CAGTNC", 2.0), (3, "ACAGTN", np.nan)]:
            rows.append(dict(
                target_id="T1", position=pos, reference_kmer=kmer,
                read_id=read, event_index=ev, model_kmer=kmer,
                samples=",".join(f"{v:.3f}" for v in rng.normal(
                    90, 5, int(rng.integers(1, 6))))))
    return pd.DataFrame(rows)


def test_read_eventalign_renames_and_filters(tmp_path):
    p = _write_eventalign(tmp_path, _eventalign_df())
    assert_same(fx.read_eventalign(p), jfx.read_eventalign(p))
    lst = tmp_path / "ids.tsv"
    pd.DataFrame({"read_id": ["r2"]}).to_csv(lst, sep="\t", index=False)
    got = fx.read_eventalign(p, sample_list=str(lst))
    assert_same(got, jfx.read_eventalign(p, sample_list=str(lst)))
    assert got.index == [3, 4, 5]


def test_read_eventalign_reverse_position(tmp_path):
    p = _write_eventalign(tmp_path, _eventalign_df())
    assert_same(fx.read_eventalign(p, reverse=True, target_len=10),
                jfx.read_eventalign(p, reverse=True, target_len=10))
    with pytest.raises(ValueError, match="requires target_len"):
        fx.read_eventalign(p, reverse=True)


@pytest.mark.parametrize("fix", [True, False])
def test_fix_reversed_reference_kmers(tmp_path, fix):
    df = _polished_eventalign()
    assert_same(fx._fix_reversed_reference_kmers(_table(df)),
                jfx._fix_reversed_reference_kmers(df))
    # through the reader, from a gzipped file named by target and strand
    with gzip.open(tmp_path / "T1_+_eventalign.dat.gz", "wt") as fh:
        df.rename(columns={"target_id": "contig", "read_id": "read_name"}
                  ).to_csv(fh, sep="\t", index=False)
    opts = dict(target_id_strand=("T1", "+"), fix_reversed_kmers=fix)
    got = fx.read_eventalign(str(tmp_path), **opts)
    assert_same(got, jfx.read_eventalign(str(tmp_path), **opts))
    assert (got["reference_kmer"][0] == "ACGNAC") == fix


def test_reverse_unreverse_eventalign_roundtrip():
    """Ties of read_id and position broken by event_index (NaN last,
    descending in ``unreverse``), as pandas' sort breaks them."""
    for df in (_eventalign_df(), _polished_eventalign(),
               pd.concat([_polished_eventalign()] * 2, ignore_index=True)):
        rev = fx.reverse_eventalign(_table(df), target_len=10)
        jrev = jfx.reverse_eventalign(df, target_len=10)
        assert_same(rev, jrev)
        assert_same(fx.unreverse_eventalign(rev, target_len=10),
                    jfx.unreverse_eventalign(jrev, target_len=10))


def test_invert_extract_count_samples():
    for df in (_eventalign_df(), _polished_eventalign()):
        t = _table(df)
        assert_same(fx.invert_samples(t), jfx.invert_samples(df))
        for n in (0, 2, len(df)):
            got = fx.extract_samples(t.rows(np.arange(n)))
            want = jfx.extract_samples(df.head(n))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(fx.count_samples(t),
                                      jfx.count_samples(df).to_numpy())
        assert fx.count_samples(t, sum_all=True) == \
            jfx.count_samples(df, sum_all=True)


@pytest.mark.parametrize("x_pos,kmer_len,margin", [(2, 2, 0), (3, 3, 1),
                                                   (40, 2, 0)])
def test_extract_seq_samples_long_format(x_pos, kmer_len, margin):
    df = _polished_eventalign()
    df = df[df.read_id == "r1"]
    got = fx.extract_seq_samples(_table(df), x_pos=x_pos, kmer_len=kmer_len,
                                 margin=margin)
    assert_same(got, jfx.extract_seq_samples(df, x_pos=x_pos,
                                             kmer_len=kmer_len,
                                             margin=margin))


def _demux_df():
    return pd.DataFrame({
        "read_id": ["a", "b", "c", "d", "e"],
        "barcode_name": ["T1", "PC_T1", "T2", "T1", "T2"],
        "read_length": [100, 250, 400, 90, 300],
        "read_start": [0, 0, 0, 0, 5],
        "read_end": [90, 240, 380, 80, 290],
        "n_matches": [85, 230, 300, 40, 250],
        "target_length": [100, 100, 400, 100, 300],
        "barcode_distance": [1, 2, 7, 0, 3],
        "target_acc": [0.91, 0.85, np.nan, 0.5, 0.97],
        "strand": ["F", "R", "F", "R", "F"],
    }).set_index("read_id")


def _ids(tmp_path, name, ids):
    p = tmp_path / name
    pd.DataFrame({"read_id": ids}).to_csv(p, sep="\t", index=False)
    return str(p)


def test_read_demux_derived_columns(tmp_path):
    p = tmp_path / "demux.csv"
    _demux_df().to_csv(p)
    assert_same(fx.read_demux(str(p)), jfx.read_demux(str(p)))
    lists = dict(exclude_list=_ids(tmp_path, "ex.tsv", ["b", "zz"]),
                 include_list=_ids(tmp_path, "in.tsv", ["a", "c", "d", "e"]),
                 sample_list=_ids(tmp_path, "s.tsv", ["e", "a", "d"]))
    got = fx.read_demux(str(p), **lists)
    assert_same(got, jfx.read_demux(str(p), **lists))
    assert got.index == ["e", "a", "d"]
    assert got.loc["a", "type"] == "XNA"


@pytest.mark.parametrize("opts", [
    dict(read_len_interval=(95, 300), max_barcode_dist=5, read_type="XNA"),
    dict(min_target_cover=0.9, min_target_acc=0.8),
    dict(min_target_cover=0.95, use_tpl_coverage=False),
    dict(read_type="PC")])
def test_filter_demux_chain(tmp_path, opts):
    p = tmp_path / "demux.csv"
    df = _demux_df()
    df["target_cover"] = [0.9, 0.99, 0.95, 0.8, 1.0]
    df.to_csv(p)
    logs = {"port": [], "jax": []}
    for who, mod in (("port", fx), ("jax", jfx)):
        (tmp_path / who).mkdir()
        out = mod.filter_demux(mod.read_demux(str(p)), **opts,
                               output_dir=str(tmp_path / who),
                               log=logs[who].append)
        if who == "port":
            got = out
        else:
            want = out
    assert_same(got, want)
    assert logs["port"][:-1] == logs["jax"][:-1]
    saved = [sorted((tmp_path / who).glob("demux-k_15-w_5*.csv.gz"))
             for who in ("port", "jax")]
    assert len(saved[0]) == 1 and saved[0][0].name == saved[1][0].name
    assert gzip.decompress(saved[0][0].read_bytes()) == \
        gzip.decompress(saved[1][0].read_bytes())


def test_qual_per_pos_explodes():
    df = pd.DataFrame({"read_id": ["a", "b", "c"], "length": [2, 1, 0]})
    quals = [np.array([10, 20]), np.array([30]), np.array([], np.int64)]
    assert_same(fx.qual_per_pos(_table(df), quals),
                jfx.qual_per_pos(df, quals))
    # one read: JAX's Series, the port's dict
    row = df.iloc[0]
    assert_same(fx.qual_per_pos(row.to_dict(), np.array([5.0, 6.0, 7.0])),
                jfx.qual_per_pos(row, np.array([5.0, 6.0, 7.0])))


@pytest.mark.parametrize("cs", [":3*at-cc+gg:4", "-aa:5+t:3", ":10", "*ac:9"])
def test_target_to_read_index_ops(cs):
    rec = dict(target_length=10, target_start=0, read_start=0, cs=cs)
    np.testing.assert_array_equal(fx._target_to_read_index(rec, n_read=10),
                                  jfx._target_to_read_index(rec, n_read=10))


def test_ub_area_qual_windows():
    rec = dict(target_length=20, target_start=0, read_start=0,
               cs=":8-ga:5+c:5")
    q = np.random.default_rng(2).integers(2, 40, 20).astype(float)
    for ub_pos, margin in (([10], 2), ([6, 12], 3), ([1], 2), ([18], 2)):
        got = fx.ub_area_qual(rec, q, ub_pos=ub_pos, margin=margin)
        want = jfx.ub_area_qual(rec, q, ub_pos=ub_pos, margin=margin)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_all_ub_area_qual_uses_strand_positions():
    class Refs:
        x_pos = {"T": [10], "PC_T": []}
        x_pos_rev = {"T": [9], "PC_T": []}

    recs = [dict(read_id=rid, target_id=tid, strand=strand,
                 target_length=20, target_start=0, read_start=0, cs=":20")
            for rid, tid, strand in (("f", "T", "F"), ("r", "T", "R"),
                                     ("m", "T", "-"), ("p", "PC_T", "F"),
                                     ("u", "U", "F"), ("q", "T", "F"))]
    rng = np.random.default_rng(4)
    quals = {k: rng.integers(2, 40, 20).astype(float)
             for k in ("f", "r", "m", "p", "u")}
    got = fx.all_ub_area_qual(recs, Refs(), quals, margin=1)
    want = jfx.all_ub_area_qual(recs, Refs(), quals, margin=1)
    assert list(got) == list(want) == ["f", "r", "m"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_reads_count_per_target_and_stats(tmp_path):
    df = pd.DataFrame({
        "target_id": ["T1", "T1", "T1", "T2", "T9", "T2"],
        "strand": ["F", "F", "R", "+", "-", "+"],
        "type": ["XNA", "XNA", "XNA", "PC", "PC", "XNA"],
        "n_matches": [90, 80, 85, 70, 13, 61],
        "alignment_block_length": [100, 100, 97, 100, 17, 71],
    })
    p = tmp_path / "reads.csv"
    df.to_csv(p, index=False)
    t = read_csv(str(p))
    for targets, agg in ((["T1", "T2", "T3"], True), (["T3", "T2"], False)):
        assert_same(fx.reads_count_per_target(t, targets, agg),
                    jfx.reads_count_per_target(df, targets, agg))

    class Refs:
        targets_id = ["T1", "T2", "T3"]

    for refs in (Refs(), None):
        got, want = fx.reads_stats(t, refs), jfx.reads_stats(df, refs)
        assert got == want and list(got) == list(want)


def test_slice_eventalign_focus_and_pc_majority(tmp_path):
    """The majority k-mer per position; where two k-mers tie, the one
    pandas' quicksort of the counts leaves last.  The fixture has enough
    positions (and ties) that a stable sort would keep another k-mer."""
    class Refs:
        x_pos = {"T1": [20]}

        def get_complement_target_id(self, tid):
            return "T1"

    rng = np.random.default_rng(5)
    rows, ties = [], 0
    for pos in range(30):
        n_a, n_b = (int(c) for c in rng.integers(1, 4, 2))
        ties += n_a == n_b
        for kmer, n in (("AAAAAA", n_a), ("NNNNNN", n_b)):
            rows += [dict(target_id="T1", position=pos, reference_kmer=kmer,
                          read_id="r", event_index=1.0, model_kmer=kmer,
                          samples="1.0")] * n
    assert ties >= 5
    df = pd.DataFrame(rows)
    p = _write_eventalign(tmp_path, df)
    t, jdf = fx.read_eventalign(p), jfx.read_eventalign(p)
    for kmer_len, margin in ((3, 0), (6, 4), (25, 5)):
        for majority in (False, True):
            opts = dict(kmer_len=kmer_len, margin=margin,
                        pc_majority=majority)
            got = fx.slice_eventalign(t, Refs(), "T1", **opts)
            assert_same(got, jfx.slice_eventalign(jdf, Refs(), "T1", **opts))
            pc = fx.slice_eventalign(t, Refs(), "PC_T1", **opts)
            assert_same(pc, jfx.slice_eventalign(jdf, Refs(), "PC_T1",
                                                 **opts))
    counts = jdf.groupby(["position", "model_kmer"]).size()
    stable = counts.sort_values(kind="stable").groupby(level=0).tail(1)
    quick = counts.sort_values().groupby(level=0).tail(1)
    assert set(stable.index) != set(quick.index)


def test_read_demux_template_coverage_without_cover_fallback(tmp_path):
    # CSV already carrying read_alignment_cover but NOT template_coverage
    df = _demux_df().rename(columns={"barcode_name": "target_id"})
    df["read_alignment_cover"] = 0.9
    df["is_pc"] = [False, True, False, False, True]
    p = tmp_path / "demux.csv"
    df.to_csv(p)
    got = fx.read_demux(str(p))
    assert_same(got, jfx.read_demux(str(p)))
    assert got.loc["c", "template_coverage"] == 380 / 400


def _summary_dirs(tmp_path, rng):
    """Three runs: two with a summary each (different columns: the second
    lacks ``acc_pc`` and adds ``err_far_ub``), one without."""
    dirs = []
    for run, extra in (("runA", {"acc_pc": 88.123456}),
                       ("runB", {"err_far_ub": 3.25, "f1_score": np.nan}),
                       ("runC", None)):
        d = tmp_path / run
        dirs.append(str(d))
        if extra is None:
            (d / "basecalls").mkdir(parents=True)
            continue
        for sub in ("basecalls", "basecalls-weights_2"):
            (d / sub).mkdir(parents=True)
            pd.DataFrame([{
                "num_aligned_reads": int(rng.integers(5, 500)),
                "ub_acc": float(rng.uniform(50, 99)),
                "acc_xna": float(rng.uniform(80, 99)),
                "demux": "k15", "ignored": 1.5, **extra,
            }]).to_csv(d / sub / "results_summ-POC-test.csv", index=False)
    return dirs


def test_comp_basecalls_perf_prints_and_writes_what_pandas_does(tmp_path):
    dirs = _summary_dirs(tmp_path, np.random.default_rng(6))
    outs = {}
    for who, fn in (("port", tcomp), ("jax", jcomp)):
        logs = []
        view = fn(dirs, out_csv=str(tmp_path / f"{who}.csv"),
                  log=logs.append)
        outs[who] = (view, logs)
    assert_same(outs["port"][0], outs["jax"][0])
    assert outs["port"][1] == outs["jax"][1]
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    assert list(outs["port"][0]["run"]) == ["runA", "runB"]
    # no summaries: the warning, and an empty table
    logs = []
    assert tcomp([dirs[2]], log=logs.append).empty
    assert logs == ["[WARNING] no results found to compare"]
