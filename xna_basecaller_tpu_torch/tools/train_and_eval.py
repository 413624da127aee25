"""Copied from ``xna_basecaller_tpu/tools/train_and_eval.py``, with a
``device`` for the training and the basecalls (the card unless ``"cpu"``).

Full pipeline: train -> per-epoch UB validation -> best-epoch test eval.

Python orchestration of the reference's shell pipeline (reference:
train_and_eval.sh:102-162 + run_ub_validation.sh:65-75): train with the
requested augmentation, basecall + evaluate the validation split for every
epoch checkpoint, consolidate to pick the best epoch (symlinking
weights_99), then evaluate the test split with it.  All stages are
idempotent and resumable, mirroring the scripts' skip-if-output-exists
behaviour.
"""

from __future__ import annotations

import os
from glob import glob

from xna_basecaller_tpu_torch.tools.consolidate_ub_validation import (
    consolidate_ub_validation,
)
from xna_basecaller_tpu_torch.tools.eval_model import eval_model


def run_ub_validation(model_dir: str, exp: str, reads_dir: str | None = None,
                      read_ids: str | None = None, ubs: str = "XY",
                      fastq_per_epoch: dict | None = None,
                      device: str = "cuda", log=print) -> int | None:
    """Evaluate every epoch checkpoint on the validation split and pick the
    best (reference run_ub_validation.sh:65-75).

    ``fastq_per_epoch`` optionally maps epoch -> existing fastq (tests /
    reuse); otherwise each epoch basecalls ``reads_dir``.
    """
    import re

    weight_files = glob(os.path.join(model_dir, "weights_*.npz"))
    epochs = sorted({
        int(m.group(1)) for f in weight_files
        if (m := re.search(r"weights_(\d+)\.npz$", f)) and not os.path.islink(f)
    })
    epochs = [e for e in epochs if e != 99]
    if fastq_per_epoch is not None:
        # the caller pre-basecalled a validation subset (e.g. every Nth
        # checkpoint of a long training) — judge only those epochs
        epochs = [e for e in epochs if e in fastq_per_epoch]
    for epoch in epochs:
        out_dir = os.path.join(model_dir, f"basecalls-weights_{epoch}")
        summ = os.path.join(out_dir, f"results_summ-{exp}-val.csv")
        if os.path.exists(summ):
            log(f"> epoch {epoch}: validation summary exists, skipping")
            continue
        fq = (fastq_per_epoch or {}).get(epoch)
        eval_model(exp, out_dir, split="val", reads_fastq=fq,
                   model_dir=model_dir, reads_dir=reads_dir,
                   read_ids=read_ids, ubs=ubs, weights=epoch,
                   device=device, log=log)
    return consolidate_ub_validation(model_dir, exp=exp, split="val",
                                     log=log)


def train_and_eval(workdir: str, data_dir: str, exp: str = "POC",
                   epochs: int = 5, batch: int = 64, lr: float = 5e-4,
                   ubs: str = "XY", spike: bool = False,
                   stitch: bool = False, ub_prop: float = 0.10,
                   pretrained: str = "", config: str | None = None,
                   val_reads_dir: str | None = None,
                   val_read_ids: str | None = None,
                   test_reads_dir: str | None = None,
                   test_read_ids: str | None = None,
                   extra_train_args: list[str] | None = None,
                   extra_eval_exps: list[str] | None = None,
                   device: str = "cuda", log=print) -> dict:
    """End-to-end: train, validate per epoch, pick best, test-eval.

    ``extra_train_args`` passes any cli/train knob through verbatim (the
    reference getopts surface: freeze/unfreeze, drop rates, std_dist,
    stitch noise/permute, weighted pos pick, ...);
    ``extra_eval_exps`` evaluates the best checkpoint on additional
    libraries (reference -E, train_and_eval.sh:58).
    """
    from xna_basecaller_tpu_torch.cli.train import argparser
    from xna_basecaller_tpu_torch.cli.train import main as train_main

    # 1) training (resumable: Trainer picks up the latest epoch)
    argv = [workdir, "--directory", data_dir, "--epochs", str(epochs),
            "--batch", str(batch), "--lr", str(lr), "-f",
            "--device", device]
    if pretrained:
        argv += ["--pretrained", pretrained]
    if config:
        argv += ["--config", config]
    if ubs:
        argv += ["--ubs", ubs]
    if spike:
        argv += ["--spike"]
    if stitch:
        argv += ["--stitch"]
    argv += ["--ub-prop", str(ub_prop)]
    if extra_train_args:
        argv += list(extra_train_args)
    args = argparser().parse_args(argv)
    train_main(args)

    # 2) per-epoch validation + best-epoch selection
    best = None
    if val_reads_dir is not None:
        best = run_ub_validation(workdir, exp, reads_dir=val_reads_dir,
                                 read_ids=val_read_ids, ubs=ubs,
                                 device=device, log=log)

    # 3) test evaluation with the best (or last) checkpoint, on the main
    # library plus any extra eval libraries (reference -E)
    summary = {}
    extra = {}
    if test_reads_dir is not None:
        out_dir = os.path.join(workdir, "basecalls-test")
        summary = eval_model(
            exp, out_dir, split="test", model_dir=workdir,
            reads_dir=test_reads_dir, read_ids=test_read_ids, ubs=ubs,
            weights=99 if best is not None else None, device=device,
            log=log)
        for x_exp in extra_eval_exps or ():
            x_dir = os.path.join(workdir, f"basecalls-{x_exp}-test")
            extra[x_exp] = eval_model(
                x_exp, x_dir, split="test", model_dir=workdir,
                reads_dir=test_reads_dir, read_ids=test_read_ids,
                ubs=ubs, weights=99 if best is not None else None,
                device=device, log=log)
    return {"best_epoch": best, "test_summary": summary,
            "extra_eval": extra}
