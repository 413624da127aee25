"""Copied from ``xna_basecaller_tpu/tools/consolidate_ub_validation.py``,
with the DataFrame replaced by ``eval/table.py``'s ``Table`` (the machine
with the card has no pandas): ``collect_epoch_summaries`` returns a Table
indexed by epoch, from which ``df.loc[epoch, "err_only_ub"]`` reads as it
does from JAX's DataFrame.

Per-epoch validation consolidation and best-epoch selection.

Re-implements the reference tool (reference: src/tools/
consolidate_ub_validation.py:63-308): read every epoch's
``basecalls-weights_N/results_summ-*.csv``, tabulate UB / area / far
accuracies, pick the best epoch by ``err_only_ub`` (ties broken by
``err_far_ub``), and symlink ``weights_99`` -> best epoch plus
``basecalls`` -> best basecalls dir.
"""

from __future__ import annotations

import csv
import os
import re
from glob import glob

import numpy as np

from xna_basecaller_tpu_torch.eval.table import Table


def _value(text: str):
    """A CSV field as ``pd.read_csv`` types it: int, float (``nan`` too),
    bool, else the string."""
    if text in ("True", "False"):
        return text == "True"
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def collect_epoch_summaries(model_dir: str, exp: str | None = None,
                            split: str = "val") -> Table:
    """Gather results_summ CSVs across basecalls-weights_N dirs, one row
    an epoch (its first row), indexed and sorted by epoch."""
    rows = []
    for d in sorted(glob(os.path.join(model_dir, "basecalls-weights_*"))):
        m = re.search(r"weights_(\d+)$", d)
        if not m:
            continue
        epoch = int(m.group(1))
        pattern = (f"results_summ-{exp}-{split}.csv" if exp
                   else f"results_summ-*-{split}.csv")
        files = glob(os.path.join(d, pattern))
        if not files:
            continue
        with open(files[0], newline="") as fh:
            rows += [(epoch, {k: _value(v) for k, v in row.items()})
                     for row in csv.DictReader(fh)]
    rows.sort(key=lambda r: r[0])
    table = Table.from_records(r for _, r in rows)
    table.index = [e for e, _ in rows]
    table.index_names = ["epoch"]
    return table


def pick_best_epoch(summ: Table, target_metric: str = "err_only_ub") -> int:
    """Best epoch by target metric, tie-broken by err_far_ub
    (reference consolidate_ub_validation.py:211-226)."""
    vals = summ[target_metric].astype(float)
    best_val = np.nanmin(vals) if target_metric.startswith("err") \
        else np.nanmax(vals)
    cands = summ.rows(vals == best_val)
    if len(cands) > 1 and "err_far_ub" in cands:
        far = cands["err_far_ub"].astype(float)
        return int(cands.index[int(np.nanargmin(far))])
    return int(cands.index[0])


def consolidate_ub_validation(model_dir: str, exp: str | None = None,
                              split: str = "val",
                              target_metric: str = "err_only_ub",
                              symlink_best: bool = True,
                              weights_ext: str = "npz",
                              log=print) -> int | None:
    """Consolidate and (optionally) symlink the best epoch; returns it."""
    summ = collect_epoch_summaries(model_dir, exp=exp, split=split)
    if summ.empty:
        log("[WARNING] no per-epoch validation summaries found")
        return None
    show_cols = [c for c in ("err_only_ub", "err_close_ub", "err_far_ub",
                             "num_aligned_reads") if c in summ]
    log("Validation summary per epoch:")
    log(Table({c: summ[c] for c in show_cols}, index=summ.index,
              index_names=summ.index_names).to_string())

    best_epoch = pick_best_epoch(summ, target_metric)
    log(f"Best epoch is {best_epoch} by {target_metric}="
        f"{summ.loc[best_epoch, target_metric]:.2f}")

    if symlink_best:
        link = os.path.join(model_dir, f"weights_99.{weights_ext}")
        target = f"weights_{best_epoch}.{weights_ext}"
        if os.path.islink(link) or os.path.exists(link):
            os.remove(link)
        os.symlink(target, link)
        log(f"> weights_99.{weights_ext} -> {target}")

        basecalls = os.path.join(model_dir, "basecalls")
        best_dir = f"basecalls-weights_{best_epoch}"
        if os.path.islink(basecalls):
            os.remove(basecalls)
        if not os.path.exists(basecalls):
            os.symlink(best_dir, basecalls)
            log(f"> basecalls -> {best_dir}")
    return best_epoch
