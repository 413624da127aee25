"""Copied from ``xna_basecaller_tpu/tools/calibrate_qscores.py``, with the
port's imports; run as ``python -m
xna_basecaller_tpu_torch.tools.calibrate_qscores FASTQ PAF
[--update-model DIR]`` on the FASTQ of ``basecaller --qscores``.

Empirical q-score calibration.

The basecaller's per-base qualities come from Viterbi edge posteriors
whose mass is split across frames (ops/crf.py), so the raw phreds are
systematically conservative.  This tool measures the truth: walk each
aligned read's cs tag to label every base correct/incorrect, bin bases
by emitted quality, compute the empirical phred per bin, and fit the
affine remap  q_emp ≈ alpha * q_emitted + beta  (count-weighted least
squares).  The fit composes with the existing config transform
(q_emitted = scale * q_raw + bias), so applying it updates
    scale' = alpha * scale,   bias' = alpha * bias + beta.

This mirrors how production basecallers calibrate (guppy/dorado ship
per-model qscore scale/bias fitted exactly this way); the reference
inherits bonito's fixed defaults (config.toml [qscore]) and never
re-fits.
"""

from __future__ import annotations

import numpy as np

from xna_basecaller_tpu_torch.eval.cs_align import parse_cs


def per_base_correct(cs: str, q0: int, read_len: int):
    """cs tag + aligned-orientation start -> (aligned mask, correct mask)
    over the read in its ALIGNED orientation (revcomp coords for '-')."""
    aligned = np.zeros(read_len, bool)
    correct = np.zeros(read_len, bool)
    ptr = q0
    for op in parse_cs(cs):
        sym, val = op[0], op[1:]
        if sym == ":":
            n = int(val)
            aligned[ptr:ptr + n] = True
            correct[ptr:ptr + n] = True
            ptr += n
        elif sym == "=":
            n = len(val)
            aligned[ptr:ptr + n] = True
            correct[ptr:ptr + n] = True
            ptr += n
        elif sym == "*":
            aligned[ptr] = True
            ptr += 1
        elif sym == "+":
            n = len(val)
            aligned[ptr:ptr + n] = True  # inserted bases are errors
            ptr += n
        elif sym == "-":
            pass  # deletion: no read base carries it
    return aligned, correct


def collect_calibration_pairs(reads: dict[str, tuple[str, str]],
                              paf_records: list[dict]):
    """reads: read_id -> (sequence, qstring); paf_records: aligned dicts
    with cs tags.  Returns (q [int array], correct [bool array]) over all
    aligned bases."""
    qs, cs_ok = [], []
    for rec in paf_records:
        rid = rec["read_id"]
        if rid not in reads or not rec.get("cs"):
            continue
        seq, qstring = reads[rid]
        if len(seq) != len(qstring):
            continue
        # cs coordinates run along the aligned orientation
        if rec["strand"] == "-":
            qstr = qstring[::-1]
            q0 = rec["read_length"] - rec["read_end"]
        else:
            qstr = qstring
            q0 = rec["read_start"]
        aligned, correct = per_base_correct(rec["cs"], q0, len(seq))
        q = (np.frombuffer(qstr.encode(), np.uint8) - 33).astype(np.int32)
        qs.append(q[aligned])
        cs_ok.append(correct[aligned])
    if not qs:
        return np.empty(0, np.int32), np.empty(0, bool)
    return np.concatenate(qs), np.concatenate(cs_ok)


def fit_calibration(q: np.ndarray, correct: np.ndarray,
                    min_count: int = 50):
    """Count-weighted affine fit of empirical phred vs emitted phred.

    Returns dict(alpha, beta, table) where table rows are
    (q_emitted, n_bases, observed_err, empirical_phred)."""
    table = []
    xs, ys, ws = [], [], []
    for qv in np.unique(q):
        sel = q == qv
        n = int(sel.sum())
        if n < min_count:
            continue
        err = float(1.0 - correct[sel].mean())
        emp = -10.0 * np.log10(max(err, 1e-4))
        table.append((int(qv), n, err, float(emp)))
        xs.append(float(qv))
        ys.append(float(emp))
        ws.append(float(n))
    if len(xs) < 2:
        return {"alpha": 1.0, "beta": 0.0, "table": table}
    x = np.asarray(xs)
    y = np.asarray(ys)
    w = np.sqrt(np.asarray(ws))
    A = np.stack([x * w, w], axis=1)
    alpha, beta = np.linalg.lstsq(A, y * w, rcond=None)[0]
    return {"alpha": float(alpha), "beta": float(beta), "table": table}


def apply_to_config(model_dir: str, alpha: float, beta: float) -> tuple:
    """Compose the fitted remap with the model's qscore transform and
    write the updated config.toml; returns (scale', bias')."""
    from dataclasses import replace

    from xna_basecaller_tpu_torch.core import config as config_lib

    cfg = config_lib.load(model_dir)
    new_scale = alpha * cfg.qscore.scale
    new_bias = alpha * cfg.qscore.bias + beta
    cfg = replace(cfg, qscore=replace(
        cfg.qscore, scale=float(new_scale), bias=float(new_bias)))
    config_lib.save(cfg, model_dir)
    return new_scale, new_bias


def calibrate(fastq_path: str, paf_path: str, model_dir: str | None = None,
              min_count: int = 50, log=print) -> dict:
    """File-level entry: fastq with qualities + PAF(cs) -> fit (+ config
    update when model_dir is given)."""
    from xna_basecaller_tpu_torch.data.writers import read_fastq_seqs_quals
    from xna_basecaller_tpu_torch.eval.ref_align import read_paf

    reads = read_fastq_seqs_quals(fastq_path)
    recs = read_paf(paf_path)
    q, correct = collect_calibration_pairs(reads, recs)
    if not len(q):
        raise ValueError("no aligned bases to calibrate on")
    fit = fit_calibration(q, correct, min_count=min_count)
    log(f"> {len(q):,} aligned bases, "
        f"alpha={fit['alpha']:.4f} beta={fit['beta']:.4f}")
    for qv, n, err, emp in fit["table"]:
        log(f"    q{qv:<3d} n={n:<9,d} err={err:.4f} empirical={emp:.2f}")
    if model_dir is not None:
        scale, bias = apply_to_config(model_dir, fit["alpha"], fit["beta"])
        log(f"> updated {model_dir}/config.toml: "
            f"scale={scale:.4f} bias={bias:.4f}")
        fit["scale"], fit["bias"] = scale, bias
    return fit


def main(args):
    calibrate(args.fastq, args.paf, model_dir=args.update_model,
              min_count=args.min_count)


def argparser():
    import argparse

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    parser.add_argument("fastq", help="basecalls with real qualities "
                                      "(basecaller --qscores)")
    parser.add_argument("paf", help="alignments with cs tags")
    parser.add_argument("--update-model", default=None,
                        help="model directory whose qscore scale/bias to "
                             "recalibrate in place")
    parser.add_argument("--min-count", type=int, default=50)
    return parser


if __name__ == "__main__":
    main(argparser().parse_args())
