"""Copied from ``xna_basecaller_tpu/eval/forensics.py``, with the
DataFrames replaced by ``eval/table.py`` (numpy and the ``csv`` module:
the machine with the card has no pandas).  Each function gives the
columns, dtypes (object where pandas has its ``str`` dtype), values and
row labels of JAX's: tables are read as ``pd.read_csv`` types them
(``table.read_csv``), rows keep their labels through a selection, sorts
follow pandas' (a stable lexsort of ranks, NaN last; the majority k-mer of
``slice_eventalign`` through numpy's quicksort of the counts, as
``Series.sort_values`` takes it), and the mean identity is
``table.series_mean``.  A single row (JAX's ``pd.Series``) is a dict.

Signal & quality forensics over external artifacts: nanopolish
eventalign tables, demux CSVs, and per-position quality analysis.

Re-designs the research-utility tail of the reference's misc layer
(reference: src/misc/data_io.py — read_eventalign:395, read_demux:323,
read_tsv:600; src/misc/utils.py — slice_eventalign:1630,
reverse_eventalign:1724, invert/extract/count_samples:1803-1833,
extract_seq_samples:1835, filter_demux:1866, get_qual_per_pos:512,
get_ub_area_qual:544, get_all_ub_area_qual:602, get_tar_reads_count:1546).
The quality mapping works off cs-tag operations from this framework's
aligner (or minimap2) instead of re-running a Biopython global alignment
per read.
"""

from __future__ import annotations

import os

import numpy as np

from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
from xna_basecaller_tpu_torch.eval.cs_align import parse_cs
from xna_basecaller_tpu_torch.eval.table import (
    Table, column, concat, isna, read_csv, series_mean,
)

# ---------------------------------------------------------------------------
# table helpers


def _renamed(df: Table, names: dict) -> Table:
    out = df.rows(np.arange(len(df)))
    out.cols = {names.get(k, k): v for k, v in df.cols.items()}
    return out


def _copy(df: Table) -> Table:
    out = df.rows(np.arange(len(df)))
    out.cols = {k: v.copy() for k, v in out.cols.items()}
    return out


def _sort_rows(df: Table, keys: list[str], ascending: list[bool]) -> Table:
    """``df.sort_values(keys, ascending=..., ignore_index=True)``: a stable
    lexsort of each key's rank among its distinct values, NaN last."""
    labels = []
    for key, up in zip(reversed(keys), reversed(ascending)):
        v = df[key]
        na = isna(v)
        cats = np.unique(v[~na])
        codes = np.full(len(v), len(cats))
        codes[~na] = np.searchsorted(cats, v[~na])
        if not up:
            codes = np.where(na, codes, len(cats) - codes - 1)
        labels.append(codes)
    out = df.rows(np.lexsort(labels) if labels else np.arange(len(df)))
    out.index = None
    return out


# ---------------------------------------------------------------------------
# readers


def read_tsv(path: str) -> Table:
    """Tab-separated table (reference data_io.py:600-609)."""
    return read_csv(path, sep="\t")


def read_demux(path: str, sample_list: str | None = None,
               exclude_list: str | None = None,
               include_list: str | None = None) -> Table:
    """Demultiplexing table keyed by read id (reference data_io.py:323-393):
    normalises the target column name and derives is_pc / type /
    read_alignment_cover / template_coverage when absent."""
    df = read_csv(path, index_col=0)
    ids = np.array(df.index, object)
    if exclude_list is not None:
        df = df.rows(~np.isin(ids, read_tsv(exclude_list)["read_id"]))
        ids = np.array(df.index, object)
    if include_list is not None:
        df = df.rows(np.isin(ids, read_tsv(include_list)["read_id"]))
        ids = np.array(df.index, object)
    if sample_list is not None:
        at = {}
        for i, label in enumerate(df.index):
            at.setdefault(label, i)
        wanted = read_tsv(sample_list)["read_id"].tolist()
        missing = [r for r in wanted if r not in at]
        if missing:
            raise KeyError(f"{missing} not in the demux index")
        df = df.rows([at[r] for r in wanted])
    if "barcode_name" in df:
        df = _renamed(df, {"barcode_name": "target_id"})
    if "is_pc" not in df:
        df["is_pc"] = np.array([isinstance(t, str) and t.startswith("PC")
                                for t in df["target_id"].tolist()], bool)
    if "type" not in df:
        df["type"] = np.where(df["is_pc"], "PC", "XNA").astype(object)
    if "read_alignment_length" not in df:
        df["read_alignment_length"] = df["read_end"] - df["read_start"]
    with np.errstate(divide="ignore", invalid="ignore"):
        if "read_alignment_cover" not in df:
            df["read_alignment_cover"] = (
                df["n_matches"].astype(float)
                / df["read_alignment_length"].astype(float))
        if "template_coverage" not in df:
            df["template_coverage"] = np.minimum(
                df["read_alignment_length"] / df["target_length"], 1)
    return df


def filter_demux(demux_df: Table,
                 read_len_interval: tuple[int, int] | None = None,
                 max_barcode_dist: float | None = None,
                 min_target_cover: float | None = None,
                 use_tpl_coverage: bool = True,
                 min_target_acc: float | None = None,
                 max_ub_area_acc: float | None = None,
                 read_type: str | None = None,
                 output_dir: str | None = None,
                 log=None) -> Table:
    """Chained demux-quality filters (reference utils.py:1866-1955); the
    output filename encodes the applied filters exactly like the
    reference's `demux-k_15-w_5-...csv.gz` convention."""
    df = demux_df
    name = "demux-k_15-w_5"
    steps = []
    if read_type is not None:
        name += f"-{read_type}_only"
        steps.append((f"type == {read_type.upper()}",
                      lambda d: d["type"] == read_type.upper()))
    if read_len_interval is not None:
        lo, hi = read_len_interval
        name += f"-l_{lo}_{hi}"
        steps.append((f"{lo} <= read_length <= {hi}",
                      lambda d: (d["read_length"] >= lo)
                      & (d["read_length"] <= hi)))
    if min_target_cover is not None:
        key = "template_coverage" if use_tpl_coverage else "target_cover"
        name += f"-t_{min_target_cover}" + ("_tpl" if use_tpl_coverage else "")
        steps.append((f"{key} >= {min_target_cover}",
                      lambda d: d[key] >= min_target_cover))
    if max_barcode_dist is not None:
        name += f"-d_{max_barcode_dist}"
        steps.append((f"barcode_distance <= {max_barcode_dist}",
                      lambda d: d["barcode_distance"] <= max_barcode_dist))
    if min_target_acc is not None:
        name += f"-tar_acc_{min_target_acc}"
        steps.append((f"target_acc >= {min_target_acc}",
                      lambda d: d["target_acc"] >= min_target_acc))
    if max_ub_area_acc is not None:
        name += f"-ub_area_acc_{max_ub_area_acc}"
        steps.append((f"ub_area_acc <= {max_ub_area_acc}",
                      lambda d: d["ub_area_acc"] <= max_ub_area_acc))
    for what, pred in steps:
        kept = df.rows(np.asarray(pred(df), bool))
        if log:
            log(f"filter_demux: {what}: removed {len(df) - len(kept):,d}")
        df = kept
    if output_dir is not None:
        out = os.path.join(output_dir, name + ".csv.gz")
        df.to_csv(out, index=True)
        if log:
            log(f"filter_demux: saved {out}")
    return df


def read_eventalign(path: str, sample_list: str | None = None,
                    reverse: bool = False, target_len: int | None = None,
                    target_id_strand: tuple[str, str] | None = None,
                    file_tpl: str = "{}_{}_eventalign.dat.gz",
                    fix_reversed_kmers: bool = True) -> Table:
    """Nanopolish eventalign table (reference data_io.py:395-487).

    Renames contig/read_name to target_id/read_id, optionally filters to a
    read-id sample list, optionally flips `position` to reverse-strand
    coordinates, and repairs reverse-complemented `reference_kmer` values
    on polished rows (NaN event_index) — detected, as in the reference, by
    comparing the k-mer overlap direction of consecutive positions.  Rows
    keep their line numbers as labels, as pandas' default index."""
    if target_id_strand is not None:
        path = os.path.join(path, file_tpl.format(*target_id_strand))
    df = read_csv(path, sep="\t")
    df.index = list(range(len(df)))
    for gone in ("Unnamed: 0", "Unnamed: 0.1"):
        df.cols.pop(gone, None)
    df = _renamed(df, {"contig": "target_id", "read_name": "read_id"})
    if sample_list is not None:
        df = df.rows(np.isin(df["read_id"], read_tsv(sample_list)["read_id"]))
    if reverse:
        if target_len is None:
            raise ValueError("reverse=True requires target_len")
        df["position"] = -df["position"] + target_len - 1
    if fix_reversed_kmers and isna(df["event_index"]).any():
        df = _fix_reversed_reference_kmers(df)
    return df


def _fix_reversed_reference_kmers(df: Table) -> Table:
    """Reference data_io.py:436-477: polished UB rows (NaN event_index)
    were sometimes written with reverse-complement k-mers; detect by the
    overlap direction against the next position and fix all such rows."""
    labels = df.index if df.index is not None else list(range(len(df)))
    at = {label: i for i, label in enumerate(labels)}
    mask = isna(df["event_index"])
    kmers, positions = df["reference_kmer"], df["position"]
    need_fix = False
    for i in np.flatnonzero(mask):
        j = at.get(labels[i] + 1)
        if "N" not in kmers[i] or j is None:
            continue
        if positions[i] != positions[j] - 1:
            continue
        if kmers[i][:-1] == kmers[j][1:]:
            need_fix = True  # k-mer slides the wrong way -> rc'd
        break
    if need_fix:
        df = _copy(df)
        fixed = df["reference_kmer"].astype(object)
        for i in np.flatnonzero(mask):
            fixed[i] = reverse_complement_str(fixed[i])
        df["reference_kmer"] = fixed
    return df


# ---------------------------------------------------------------------------
# eventalign transforms


def slice_eventalign(df: Table, refs, target_id: str,
                     kmer_len: int = 6, margin: int = 0,
                     pc_majority: bool = True) -> Table:
    """Rows whose k-mer window covers a UB position (reference
    utils.py:1630-1674); PC targets focus the positions of their XNA
    complement.  With pc_majority, keep only the majority model_kmer per
    position (drops odd NNNNNN events, reference behaviour); where counts
    tie, the k-mer that numpy's quicksort of the counts leaves last, as
    JAX's ``counts.sort_values().groupby(level=0).tail(1)`` keeps it."""
    xna_tid = (refs.get_complement_target_id(target_id)
               if target_id.startswith("PC") else target_id)
    focus: set[int] = set()
    for p in refs.x_pos[xna_tid]:
        focus.update(range(p - kmer_len + 1 - margin, p + 1 + margin))
    out = df.rows(np.isin(df["position"], sorted(focus)))
    if pc_majority and len(out):
        groups = out.groups(["position", "model_kmer"])
        keys = list(groups)
        counts = np.array([len(v) for v in groups.values()], np.int64)
        last = {}
        for i in np.argsort(counts, kind="quicksort"):
            last[keys[i][0]] = keys[i]
        keep = set(last.values())
        out = out.rows([key in keep for key in zip(
            out["position"].tolist(), out["model_kmer"].tolist())])
    return out


def reverse_eventalign(df: Table, target_len: int,
                       kmer_len: int = 6) -> Table:
    """Flip positions to signal (reverse-strand) order (reference
    utils.py:1724-1757)."""
    out = _copy(df)
    out["position"] = -df["position"] + target_len - kmer_len
    return _sort_rows(out, ["read_id", "position", "event_index"],
                      [True, True, True])


def unreverse_eventalign(df: Table, target_len: int,
                         kmer_len: int = 6) -> Table:
    """Inverse of :func:`reverse_eventalign` (reference utils.py:1759-1788)."""
    out = _copy(df)
    out["position"] = -df["position"] + target_len - kmer_len
    return _sort_rows(out, ["read_id", "position", "event_index"],
                      [True, True, False])


def invert_samples(df: Table) -> Table:
    """Reverse each row's comma-joined signal samples (reference
    utils.py:1803-1822) — used with reverse-strand eventalign."""
    out = _copy(df)
    out["samples"] = [",".join(s.split(",")[::-1])
                      for s in df["samples"].tolist()]
    return out


def extract_samples(df: Table) -> np.ndarray:
    """All signal samples of the rows as one float array (utils.py:1824)."""
    if not len(df):
        return np.empty(0)
    return np.asarray(",".join(df["samples"].tolist()).split(","),
                      dtype=float)


def count_samples(df: Table, sum_all: bool = False):
    """Per-row (or total) sample counts (utils.py:1829-1833)."""
    n = np.array([s.count(",") for s in df["samples"].tolist()],
                 np.int64) + 1
    return int(n.sum()) if sum_all else n


def extract_seq_samples(read_df: Table, x_pos: int,
                        kmer_len: int = 6, margin: int = 3) -> Table:
    """Long-format per-position signal levels around one UB position
    (reference utils.py:1835-1864): one row per raw sample with
    target_id/position/signal_level/is_pc columns."""
    lo, hi = x_pos - kmer_len + 1 - margin, x_pos + margin
    pos = read_df["position"]
    window = read_df.rows((pos >= lo) & (pos <= hi))
    target_id = read_df["target_id"][0]
    frames = []
    for (position,), rows in window.groups(["position"]).items():
        grp = window.rows(rows)
        samples = extract_samples(grp)
        n = len(samples)
        frames.append(Table({
            "target_id": np.array([grp["target_id"][0]] * n, object),
            "position": np.full(n, position, np.int64),
            "signal_level": samples,
            "is_pc": np.full(n, target_id.startswith("PC")),
        }))
    if not frames:
        return Table({k: np.empty(0, object) for k in (
            "target_id", "position", "signal_level", "is_pc")})
    return concat(frames)


# ---------------------------------------------------------------------------
# quality forensics


def qual_per_pos(reads_df: Table | dict, reads_qual) -> Table:
    """Explode per-read quality arrays into one row per (read, position)
    (reference utils.py:512-542); position is 1-based like the reference.
    A single read (a dict) becomes a one-row table whose columns share the
    dtype pandas gives the row's values together."""
    if isinstance(reads_df, dict):
        dtype = column(list(reads_df.values())).dtype
        cols = {}
        for k, v in reads_df.items():
            cols[k] = np.empty(1, object) if dtype == object else np.array(
                [v], dtype)
            cols[k][0] = v
        reads_df, reads_qual = Table(cols), [reads_qual]
    quals = [np.asarray(q) for q in reads_qual]
    reps = np.array([max(len(q), 1) for q in quals], np.int64)
    out = reads_df.rows(np.repeat(np.arange(len(reads_df)), reps))
    out.index = None
    qual_col, pos_col = [], []
    for q in quals:
        if len(q):
            qual_col.extend(q)
            pos_col.extend(np.arange(1, len(q) + 1))
        else:
            qual_col.append(np.nan)
            pos_col.append(np.nan)
    for name, vals in (("qual_score", qual_col), ("position", pos_col)):
        col = np.empty(len(vals), object)
        col[:] = vals
        out.cols[name] = col
    return out


def _target_to_read_index(record: dict, n_read: int) -> np.ndarray:
    """Map each target position to the nearest aligned read index, from
    the record's cs operations (replaces the reference's global-alignment
    reconstruction + pandas nearest-interpolation, utils.py:569-585)."""
    t_len = record["target_length"]
    idx = np.full(t_len, -1, np.int64)
    t = record["target_start"]
    r = record.get("read_start", 0)
    for op in parse_cs(record["cs"]):
        sym, val = op[0], op[1:]
        if sym in (":", "="):
            ln = int(val) if sym == ":" else len(val)
            idx[t:t + ln] = np.arange(r, r + ln)
            t += ln
            r += ln
        elif sym == "*":
            idx[t] = r
            t += 1
            r += 1
        elif sym == "+":
            r += len(val)
        elif sym == "-":
            t += len(val)
    # nearest-fill unaligned target positions
    aligned = np.flatnonzero(idx >= 0)
    if not len(aligned):
        return idx
    nearest = aligned[np.clip(
        np.searchsorted(aligned, np.arange(t_len)), 0, len(aligned) - 1)]
    left = aligned[np.clip(
        np.searchsorted(aligned, np.arange(t_len)) - 1, 0, len(aligned) - 1)]
    pick = np.where(np.abs(left - np.arange(t_len))
                    <= np.abs(nearest - np.arange(t_len)), left, nearest)
    out = idx.copy()
    out[idx < 0] = idx[pick[idx < 0]]
    return np.clip(out, 0, n_read - 1)


def ub_area_qual(record: dict, read_qual: np.ndarray, ub_pos,
                 margin: int = 5) -> np.ndarray | None:
    """Quality-score windows around each UB position of the aligned target
    (reference get_ub_area_qual, utils.py:544-600).  Returns
    [n_ubs, 2*margin+1] or None when a window falls off the read (the
    reference asserts; callers here can skip such reads)."""
    read_qual = np.asarray(read_qual, float)
    idx = _target_to_read_index(record, len(read_qual))
    rows = []
    for p in ub_pos:
        c = idx[p]
        # strict bounds match the reference's sanity assert (utils.py:592)
        if c - margin <= 0 or c + 1 + margin >= len(read_qual):
            return None
        rows.append(read_qual[c - margin:c + 1 + margin])
    return np.asarray(rows)


def all_ub_area_qual(records, refs, quals: dict[str, np.ndarray],
                     margin: int = 5) -> dict[str, np.ndarray]:
    """UB-area quality windows for every record (reference
    get_all_ub_area_qual, utils.py:602-659); `quals` maps read_id to its
    phred array (e.g. from data.writers.read_fastq_quals)."""
    out = {}
    for rec in records:
        q = quals.get(rec["read_id"])
        if q is None or rec["target_id"] not in refs.x_pos:
            continue
        ub_pos = refs.x_pos[rec["target_id"]]
        if rec.get("strand") in ("-", "R"):
            ub_pos = refs.x_pos_rev[rec["target_id"]]
        if not ub_pos:  # PC templates carry no UBs
            continue
        win = ub_area_qual(rec, q, ub_pos, margin=margin)
        if win is not None:
            out[rec["read_id"]] = win
    return out


# ---------------------------------------------------------------------------
# read-count summaries


def reads_count_per_target(reads_df: Table, targets_id,
                           agg_min_strands: bool = True) -> Table:
    """Per-target read counts split by strand, with zero rows for missing
    templates (reference get_tar_reads_count, utils.py:1546-1628).  With
    agg_min_strands, adds the min(F,R) column the reference uses to judge
    usable per-template depth.  Indexed by target_id; a strand column
    for each strand seen, in sorted order (``pd.crosstab``)."""
    strand = [{"+": "F", "-": "R"}.get(s, s)
              for s in reads_df["strand"].tolist()]
    given = ~isna(reads_df["target_id"]) & ~isna(column(strand))
    pairs = [(t, s) for t, s, ok in zip(reads_df["target_id"].tolist(),
                                        strand, given) if ok]
    targets = list(targets_id)
    at = {t: i for i, t in reversed(list(enumerate(targets)))}
    counts = {s: np.zeros(len(targets), np.int64)
              for s in sorted({s for _, s in pairs})}
    for t, s in pairs:
        if t in at:
            counts[s][at[t]] += 1
    for col in ("F", "R"):
        counts.setdefault(col, np.zeros(len(targets), np.int64))
    counts["total"] = counts["F"] + counts["R"]
    if agg_min_strands:
        counts["min_strands"] = np.minimum(counts["F"], counts["R"])
    return Table(counts, index=targets, index_names=["target_id"])


def reads_stats(reads_df: Table, refs=None) -> dict:
    """Aggregate read statistics (reference print_reads_stats,
    utils.py:1505-1544): totals, per-type counts, alignment identity."""
    tids = reads_df["target_id"]
    out = {"n_reads": int(len(reads_df)),
           "n_targets": len(set(tids[~isna(tids)].tolist()))}
    if "type" in reads_df:
        types = reads_df["type"]
        seen: dict = {}
        for t in types[~isna(types)].tolist():
            seen[t] = seen.get(t, 0) + 1
        for t, c in sorted(seen.items(), key=lambda kv: -kv[1]):
            out[f"n_{t.lower()}"] = int(c)
    if "n_matches" in reads_df and "alignment_block_length" in reads_df:
        with np.errstate(divide="ignore", invalid="ignore"):
            out["mean_identity"] = float(series_mean(
                reads_df["n_matches"] / reads_df["alignment_block_length"]))
    if refs is not None:
        counts = reads_count_per_target(reads_df, refs.targets_id)
        out["templates_covered"] = int((counts["total"] > 0).sum())
        out["min_reads_per_template"] = int(counts["total"].min())
    return out
