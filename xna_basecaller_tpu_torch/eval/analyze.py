"""Copied from ``xna_basecaller_tpu/eval/analyze.py``, with the DataFrames
replaced by ``eval/table.py`` (numpy and the ``csv`` module: the machine
with the card has neither pandas nor sklearn).  It computes the same
summary and writes the same CSV family, in the same columns, order and
number format; the base confusion matrix is counted with numpy, as
``sklearn.metrics.confusion_matrix`` counts it.

UB evaluation engine: per-position error rates and UB-detection metrics.

Re-implements the reference's analyze_paf (reference: src/tools/
analyze_paf.py:538-1051 + the error-rate machinery in src/misc/utils.py):
barcode demux filtering, strand filtering (X reads are F, Y reads are R,
analyze_paf.py:652-658), per-read error vectors with UB-indel polish,
per-(target,strand) positional error rates, UB-distance-sliced statistics,
FPR/FDR/F1/F2, and the results_summ CSV family (+ -by_tar, -by_tar_pos).
"""

from __future__ import annotations

import os

import numpy as np

from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
from xna_basecaller_tpu_torch.eval import cs_align
from xna_basecaller_tpu_torch.eval.table import (
    Table, group_mean, series_mean,
)
from xna_basecaller_tpu_torch.eval.xna_refs import EXP_REF_MAP, XnaRefs

CONFUSION_LABELS = ("A", "T", "C", "G", "X", "Y", "-")


def compute_stats_error_rate(error_rate, x_positions, kmer_len: int = 6,
                             max_dist: int = 10) -> dict[str, np.ndarray]:
    """Slice positional error rates by distance to UBs
    (reference analyze_paf.py:111-190)."""
    if len(x_positions) == 0:
        raise ValueError("x_positions is empty: " + str(x_positions))
    error_rate = np.asarray(error_rate)
    cuts = {}
    no_ub = np.ones(len(error_rate), bool)
    influence = np.zeros(len(error_rate), bool)
    for p in x_positions:
        influence[max(0, p + 1 - kmer_len): p + kmer_len] = True
    for p in x_positions:
        no_ub[p] = False
        influence[p] = True
    cuts["only_ub"] = error_rate[~no_ub]
    cuts["no_ub"] = error_rate[no_ub]
    cuts["outside_ub_area"] = error_rate[~influence]
    cuts["inside_ub_area"] = error_rate[influence & no_ub]
    cuts["ub_and_ub_area"] = error_rate[influence]
    positions = np.arange(len(error_rate))
    dists = np.array([min(abs(p - x) for x in x_positions)
                      for p in positions])
    for d in range(1, max_dist + 1):
        cuts[f"dist_ub_d-{d}"] = error_rate[dists == d]
    cuts[f"dist_ub_d-{max_dist + 1}+"] = error_rate[dists >= max_dist + 1]
    return cuts


def _oriented_read_seq(rec: dict, seq: str) -> str:
    """Aligned read sub-sequence in target-forward orientation
    (reference data_io.get_read_seq with read_info)."""
    sub = seq[rec["read_start"]:rec["read_end"]]
    if rec["strand"] in ("-", "R"):
        sub = reverse_complement_str(sub)
    return sub


def add_barcode_info(paf: Table, refs: XnaRefs, reads: dict[str, str],
                     n_relax_bases: int = 3) -> Table:
    """Append barcode columns (reference utils.add_barcode_info:1436)."""
    rows = []
    for rec in paf.records():
        barcode = refs.barcodes[rec["target_id"]]
        info = cs_align.barcode_match(
            rec, reads[rec["read_id"]], refs.left_primer_len, barcode,
            n_relax_bases=n_relax_bases)
        info["barcode"] = barcode
        info["barcode_cnt"] = refs.barcodes_cnt[rec["target_id"]]
        rows.append(info)
    return paf.join(Table.from_records(rows))


def _keep_best_barcodes(paf: Table, max_bc_dist: int) -> Table:
    """The alignments within ``max_bc_dist`` of their barcode, and of
    those, each read's nearest (all that tie)."""
    paf = paf.rows(paf["barcode_distance"] <= max_bc_dist)
    best: dict = {}
    for rid, d in zip(paf["read_id"].tolist(),
                      paf["barcode_distance"].tolist()):
        best[rid] = min(best.get(rid, d), d)
    return paf.rows([best[r] == d for r, d in zip(
        paf["read_id"].tolist(), paf["barcode_distance"].tolist())])


def missing_templates(paf: Table, targets_id,
                      min_reads_count: int) -> list[str]:
    """The templates whose strand with the fewer reads has at most
    ``min_reads_count`` of them, sorted (reference
    utils.get_tar_reads_count:1546-1628 with agg_min_strands)."""
    counts: dict = {}
    for key in zip(paf["target_id"].tolist(), paf["strand"].tolist()):
        counts[key] = counts.get(key, 0) + 1
    return sorted(t for t in set(targets_id)
                  if min(counts.get((t, "F"), 0), counts.get((t, "R"), 0))
                  <= min_reads_count)


def read_confusion_matrix(errors_tm: np.ndarray, target: str,
                          strand: str) -> np.ndarray:
    """Per-read base confusion counts over the full-length aligned read
    (reference analyze_paf.compute_read_confusion_matrix:520-536): rows are
    the true bases A,T,C,G,X,Y, columns the called A,T,C,G,X,Y,- (deletion).
    """
    tm = "".join(errors_tm)
    if strand in ("-", "R"):
        tm = reverse_complement_str(tm)
        target = reverse_complement_str(target)
    return confusion_matrix(list(target), list(tm),
                            CONFUSION_LABELS)[:-1, :]  # no '-' true row


def confusion_matrix(y_true, y_pred, labels) -> np.ndarray:
    """``sklearn.metrics.confusion_matrix(y_true, y_pred, labels=labels)``:
    counts of (true, called) pairs, rows and columns in ``labels``' order;
    pairs with a value outside ``labels`` are not counted."""
    pos = {lab: i for i, lab in enumerate(labels)}
    if not any(lab in pos for lab in y_true):
        raise ValueError("At least one label specified must be in y_true")
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true, y_pred):
        if t in pos and p in pos:
            cm[pos[t], pos[p]] += 1
    return cm


def analyze_paf(exp_name: str, paf_records, reads: dict[str, str],
                max_bc_dist: int | None = None, ubs: str = "XY",
                only_strand: str | None = None, max_dist: int = 4,
                out_dir: str | None = None, out_prefix: str = "results_summ",
                refs: XnaRefs | None = None, polish: bool = True,
                save_detailed_perf: bool = True,
                save_perf_per_read: bool = False,
                targets_list=None, include_list=None,
                min_reads_count: int | None = None, debug: bool = False,
                save_confusion_matrix: bool = False,
                read_quals: dict | None = None,
                oracle_demux: bool = False,
                log=print) -> dict:
    """Full evaluation; returns the summary dict and writes the CSV family.

    paf_records: list of PAF record dicts (eval.ref_align format).
    reads: read_id -> basecalled sequence (the fastq content).
    targets_list / include_list: optional target-id / read-id whitelists
    (reference analyze_paf.py:605-619); min_reads_count reports templates
    with insufficient reads and writes ``{prefix}-missing_templates.txt``
    (reference analyze_paf.py:694-706); debug analyzes only the first 1000
    alignments (analyze_paf.py:580-584); save_confusion_matrix writes the
    summed base confusion matrix as ``{prefix}-confusion_matrix.npy``
    (analyze_paf.py:728-737); read_quals (read_id -> phred array) adds
    mapped-region mean q-scores (analyze_paf.py:667-680).
    """
    ref_name = EXP_REF_MAP.get(exp_name, exp_name)
    refs = refs or XnaRefs(ref_name)
    paf = Table.from_records(paf_records)
    n_total_reads = max(len(reads), 1)
    if debug and len(paf) > 1000:
        log("[Warning] debug: using the first 1000 alignments")
        paf = paf.rows(np.arange(1000))
    align_cnt = len(set(paf["read_id"].tolist())) if len(paf) else 0
    log(f"* paf contains {align_cnt:,d} reads ({len(paf):,d} alignments)")

    if len(paf) == 0:
        return {"num_aligned_reads": 0}
    if targets_list is not None:
        keep = set(targets_list)
        paf = paf.rows([t in keep for t in paf["target_id"].tolist()])
        log(f"* after targets_list filter: {len(paf):,d} alignments")
    if include_list is not None:
        keep = set(include_list)
        paf = paf.rows([r in keep for r in paf["read_id"].tolist()])
        log(f"* after include_list filter: {len(paf):,d} alignments")
    if len(paf) == 0:
        return {"num_aligned_reads": 0}
    paf["is_pc"] = np.array([t.startswith("PC")
                             for t in paf["target_id"].tolist()], bool)
    paf["type"] = np.where(paf["is_pc"], "PC", "XNA").astype(object)
    paf["read_alignment_length"] = paf["read_end"] - paf["read_start"]

    demux_cnt = align_cnt
    demux_match_acc = None
    if oracle_demux:
        # Simulation oracle: the simulator names eval reads
        # "{target_id}_{i}" (data/simulate.py sim_library_reads), so the
        # true target of every read is known.  Bypassing barcode
        # assignment decomposes held-out ub_acc into demux-misassignment
        # vs UB-calling error; the real demux's per-read assignment
        # accuracy is measured alongside (reference demux gate:
        # eval_model.sh:64-68).
        tids = sorted(refs.targets_id, key=len, reverse=True)

        def _true_tid(rid):
            for t in tids:
                if rid.startswith(t + "_"):
                    return t
            return None

        true_map = {rid: _true_tid(rid) for rid in paf["read_id"].tolist()}
        if any(v is None for v in true_map.values()):
            n_bad = sum(v is None for v in true_map.values())
            log(f"[Warning] oracle demux: {n_bad} read ids carry no "
                "known target prefix (non-simulated reads?)")
        if max_bc_dist is not None:
            bc = _keep_best_barcodes(add_barcode_info(paf, refs, reads),
                                     max_bc_dist)
            sel: dict = {}
            for rid, tid in zip(bc["read_id"].tolist(),
                                bc["target_id"].tolist()):
                sel.setdefault(rid, set()).add(tid)
            ok = [true_map.get(r) in sel[r] for r in sorted(sel)]
            demux_match_acc = (100 * float(np.mean(ok)) if ok
                               else float("nan"))
            log(f"* real-demux assignment accuracy: {demux_match_acc:.2f}"
                f"% of {len(ok):,d} demuxed reads")
        paf = paf.rows([true_map.get(r) == t for r, t in zip(
            paf["read_id"].tolist(), paf["target_id"].tolist())])
        demux_cnt = len(set(paf["read_id"].tolist()))
        log(f"* After ORACLE demux: {demux_cnt:,d}")
    elif max_bc_dist is not None:
        log("Adding barcode information...")
        paf = _keep_best_barcodes(add_barcode_info(paf, refs, reads),
                                  max_bc_dist)
        demux_cnt = len(set(paf["read_id"].tolist()))
        log(f"* After demux (max_bc_dist {max_bc_dist}): {demux_cnt:,d}")

    if len(paf) == 0:
        return {"num_aligned_reads": 0}

    paf["strand"] = np.array([{"+": "F", "-": "R"}.get(s, s)
                              for s in paf["strand"].tolist()], object)
    if ubs != "XY":
        only_strand = dict(X="F", Y="R")[ubs]
    if only_strand is not None:
        paf = paf.rows(paf["strand"] == only_strand)
    if len(paf) == 0:
        return {"num_aligned_reads": 0}

    if min_reads_count is not None:
        missing = missing_templates(paf, refs.targets_id, min_reads_count)
        log(f"Number of missing templates (<= {min_reads_count} reads "
            f"F and/or R): {len(missing)}")
        if out_dir is not None and missing:
            os.makedirs(out_dir, exist_ok=True)
            Table({"target_id": missing}).to_csv(
                os.path.join(out_dir,
                             out_prefix + "-missing_templates.txt"),
                header=False)

    if read_quals is not None:
        paf["mean_q_score"] = [
            float(np.mean(np.asarray(read_quals[r["read_id"]])
                          [r["read_start"]:r["read_end"]]))
            for r in paf.records()]
        for strand, rows in paf.groups(["strand"]).items():
            q = paf["mean_q_score"][rows]
            log(f"mean_q_score {strand[0]}: count {len(q)}, mean "
                f"{q.mean():.1f}, min {q.min():.1f}, percentiles 1/5/10/25 "
                + "/".join(f"{v:.1f}" for v in np.percentile(
                    q, [1, 5, 10, 25])) + f", max {q.max():.1f}")

    # per-read errors + UB metrics
    errors_by_key: dict[tuple, list[np.ndarray]] = {}
    metric_rows = []
    n_match_est = []
    cm_total = np.zeros((6, 7), np.int64) if save_confusion_matrix else None
    for rec in paf.records():
        tid = rec["target_id"]
        target = refs.targets[tid]
        if not rec["is_pc"]:
            target = target.replace("N", "X")
        seq = _oriented_read_seq(rec, reads[rec["read_id"]])
        errors, tm = cs_align.compute_errors(
            rec, target, read_seq=seq, polish=polish)
        m = cs_align.ub_metrics(errors, tm, target, rec)
        metric_rows.append(m)
        n_match_est.append(len(errors) - errors.sum())
        errors_by_key.setdefault((tid, rec["strand"]), []).append(errors)
        if cm_total is not None:
            cm_total += read_confusion_matrix(tm, target, rec["strand"])

    paf = paf.join(Table.from_records(metric_rows))
    paf["read_acc"] = np.asarray(n_match_est) / paf["read_alignment_length"]
    paf["target_acc"] = np.asarray(n_match_est) / paf["target_length"]

    # per-(target,strand) positional error rates -> distance-sliced means
    # of the XNA rows, each (type, label) in row order
    err_rows: dict[tuple, list] = {}
    for (tid, strand), errs in errors_by_key.items():
        err_rate = np.nanmean(np.stack(errs), axis=0) * 100
        is_pc = tid.startswith("PC")
        xna_tid = refs.get_complement_target_id(tid) if is_pc else tid
        x_positions = (refs.x_pos[xna_tid] if strand == "F"
                       else refs.x_pos_rev[xna_tid])
        if not x_positions:
            continue
        cuts = compute_stats_error_rate(err_rate, x_positions,
                                        max_dist=max(10, max_dist))
        for label, values in cuts.items():
            err_rows.setdefault(("PC" if is_pc else "XNA", label),
                                []).extend(values.tolist())

    def _err(label):
        vals = err_rows.get(("XNA", label))
        return group_mean(vals) if vals else float("nan")

    xna = ~paf["is_pc"]
    summary = {
        "num_aligned_reads": len(set(paf["read_id"].tolist())),
        "target_acc": float(series_mean(paf["target_acc"][xna]) * 100),
        "read_acc": float(series_mean(paf["read_acc"][xna]) * 100),
        "err_far_ub": _err("outside_ub_area"),
        "err_close_ub": _err("inside_ub_area"),
        "err_only_ub": _err("only_ub"),
    }
    for d in range(1, max_dist + 1):
        summary[f"err_ub_d_{d}"] = _err(f"dist_ub_d-{d}")
    summary["acc_xna"] = float(series_mean(paf["percent_match"][xna]) * 100)
    pc_mask = paf["is_pc"]
    summary["acc_pc"] = float(
        series_mean(paf["percent_match"][pc_mask]) * 100) \
        if pc_mask.any() else float("nan")
    summary["ub_acc"] = 100 - summary["err_only_ub"]
    summary["ub_area_acc"] = 100 - summary["err_close_ub"]
    summary["demux"] = 100 * demux_cnt / n_total_reads
    summary["align"] = 100 * align_cnt / n_total_reads
    if oracle_demux:
        summary["oracle_demux"] = True
        if demux_match_acc is not None:
            summary["demux_match_acc"] = demux_match_acc

    # detection stats (reference analyze_paf.py:986-1022)
    mean_fpr = series_mean(paf["fpr"])
    mean_fdr = series_mean(paf["fdr"])
    summary["specificity"] = 100 * (1 - mean_fpr)
    summary["precision"] = 100 * (1 - mean_fdr) if np.isfinite(mean_fdr) \
        else float("nan")
    tp = int(paf["true_pos"].sum())
    fn = int(paf["false_neg"].sum())
    fp = int(paf["false_pos"].sum())
    tn = int(paf["true_neg"].sum())
    recall = tp / (tp + fn) if tp + fn else 0.0
    precision = tp / (tp + fp) if tp + fp else 0.0
    summary["f1_score"] = 100 * (2 * tp / (2 * tp + fp + fn)
                                 if tp + fp + fn else 0.0)
    beta = 2
    summary["f2_score"] = 100 * (
        (1 + beta ** 2) * precision * recall
        / (beta ** 2 * precision + recall)
        if precision + recall > 0 else 0.0)
    summary.update(true_pos=tp, false_neg=fn, false_pos=fp, true_neg=tn)
    # Wilson 95% CI on ub_acc: each aligned XNA read contributes one
    # Bernoulli observation per UB site (n = tp + fn sites), so the
    # interval tells whether the point estimate is statistically
    # distinguishable from a target band at this eval size.
    n_sites = tp + fn
    if n_sites and np.isfinite(summary["ub_acc"]):
        p_hat = summary["ub_acc"] / 100.0
        z = 1.959964
        denom = 1 + z * z / n_sites
        center = (p_hat + z * z / (2 * n_sites)) / denom
        half = (z * np.sqrt(p_hat * (1 - p_hat) / n_sites
                            + z * z / (4 * n_sites * n_sites))) / denom
        summary["ub_acc_ci_lo"] = float(100 * max(0.0, center - half))
        summary["ub_acc_ci_hi"] = float(100 * min(1.0, center + half))
    if read_quals is not None:
        summary["mean_q_score"] = series_mean(paf["mean_q_score"])

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        if cm_total is not None:
            np.save(os.path.join(out_dir,
                                 out_prefix + "-confusion_matrix.npy"),
                    cm_total)
        if save_perf_per_read:
            per_read_cols = [c for c in (
                "read_id", "target_id", "strand", "type", "percent_match",
                "read_acc", "target_acc", "ub_acc", "ub_area_acc",
                "non_ub_area_acc", "fdr", "fpr", "barcode_distance",
            ) if c in paf]
            Table({c: paf[c] for c in per_read_cols}).to_csv(
                os.path.join(out_dir, out_prefix + "-per_read.csv"),
                na_rep="nan", float_format="{:.4f}".format)
        Table.from_records([summary]).to_csv(
            os.path.join(out_dir, out_prefix + ".csv"), na_rep="nan",
            float_format="{:.3f}".format)
        if save_detailed_perf:
            _by_tar(paf).to_csv(
                os.path.join(out_dir, out_prefix + "-by_tar.csv"),
                index=True, na_rep="nan", float_format="{:.3f}".format)
            # per-UB-position breakdown: written when any target has >1 UB,
            # and then covers ALL XNA rows (reference analyze_paf.py:822-834
            # gates on label_per_pos.apply(len).max() > 1 but aggregates the
            # whole non-PC frame)
            multi = paf.rows(xna)
            if len(multi) and max(len(v) for v in multi["label_per_pos"]) > 1:
                rows = []
                for (strand, tid), grp in multi.groups(
                        ["strand", "target_id"]).items():
                    accs = np.mean(np.stack(
                        multi["ub_acc_per_pos"][grp].tolist()), axis=0)
                    areas = np.mean(np.stack(
                        multi["ub_area_acc_per_pos"][grp].tolist()), axis=0)
                    labels = multi["label_per_pos"][grp[0]]
                    for order, (lab, a, ar) in enumerate(
                            zip(labels, accs, areas), 1):
                        rows.append((strand, tid, lab, order,
                                     100 * a, 100 * ar))
                names = ("strand", "target_id", "label", "ub_order",
                         "ub_acc", "ub_area_acc")
                Table({n: [r[i] for r in rows]
                       for i, n in enumerate(names)}).to_csv(
                    os.path.join(out_dir, out_prefix + "-by_tar_pos.csv"),
                    float_format="{:.3f}".format)
    return summary


def _by_tar(paf: Table) -> Table:
    """Means by (target_id, strand, type), in percent, and the read count,
    all as floats (reference analyze_paf.py:810-821)."""
    groups = paf.groups(["target_id", "strand", "type"])
    cols = {c: [group_mean(paf[c][rows]) * 1.0 * 100
                for rows in groups.values()]
            for c in ("ub_acc", "ub_area_acc", "non_ub_area_acc",
                      "percent_match")}
    cols["read_id"] = [len(rows) * 1.0 for rows in groups.values()]
    return Table(cols, index=list(groups),
                 index_names=["target_id", "strand", "type"])
