"""Copied from ``xna_basecaller_tpu/tools/comp_basecalls_perf.py``, with
the DataFrame replaced by ``eval/table.py``'s ``Table`` (the machine with
the card has no pandas): the summaries are read by ``table.read_csv`` and
stacked by ``table.concat``, and the printed view and ``out_csv`` are the
text of pandas' ``round(1).to_string(index=False)`` and
``to_csv(index=False)``.

Compare evaluation results across training runs.

Re-implements the reference tool (reference: src/tools/
comp_basecalls_perf.py): read ``results_summ-{EXP}-{split}.csv`` from each
training directory's basecalls and tabulate UB / area / DNA accuracies
side by side (csv or pretty print).
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from xna_basecaller_tpu_torch.eval.table import Table, concat, read_csv

KEY_COLS = ["ub_acc", "ub_area_acc", "acc_xna", "acc_pc", "err_far_ub",
            "f1_score", "demux", "align", "num_aligned_reads"]


def collect_run_summaries(train_dirs: list[str], exp: str = "POC",
                          split: str = "test") -> Table:
    rows = []
    for d in train_dirs:
        pattern = os.path.join(
            d, "basecalls*", f"results_summ-{exp}-{split}.csv")
        files = sorted(glob(pattern))
        if not files:
            continue
        df = read_csv(files[-1])
        run = np.empty(len(df), object)
        run[:] = os.path.basename(os.path.normpath(d))
        df.cols = {"run": run, **df.cols}
        rows.append(df)
    if not rows:
        return Table()
    return concat(rows)


def comp_basecalls_perf(train_dirs: list[str], exp: str = "POC",
                        split: str = "test", out_csv: str | None = None,
                        log=print) -> Table:
    df = collect_run_summaries(train_dirs, exp=exp, split=split)
    if df.empty:
        log("[WARNING] no results found to compare")
        return df
    cols = ["run"] + [c for c in KEY_COLS if c in df.columns]
    view = Table({c: df[c] for c in cols})
    log(view.round(1).to_string())
    if out_csv:
        view.to_csv(out_csv, index=False)
    return view
