"""``xnacall evaluate`` — chunk-level accuracy on ctc-data validation.

Port of ``xna_basecaller_tpu/cli/evaluate.py`` with its flags plus
``--device``: the multi-checkpoint sweep (comma-separated ``--weights``)
and ``--poa``, the per-chunk POA consensus across the evaluated
checkpoints, scored like a single model (the reference's own --poa path
crashes with a NameError, evaluate.py:84).  Each batch runs the inference
forward and the decode on the device (for the CRF family K1, then K2a,
K2b and K2c on the card); the POA runs on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(args):
    import torch

    from xna_basecaller_tpu_torch.core.alphabet import decode as decode_codes
    from xna_basecaller_tpu_torch.data.ctc_data import load_numpy_datasets
    from xna_basecaller_tpu_torch.eval.accuracy import accuracy
    from xna_basecaller_tpu_torch.train import loop
    from xna_basecaller_tpu_torch.utils.device import on_device
    from xna_basecaller_tpu_torch.utils.model_io import load_model

    np.random.seed(args.seed)

    print("* loading data", file=sys.stderr)
    directory = args.directory
    valid_dir = os.path.join(directory, "validation")
    if os.path.exists(valid_dir):
        directory = valid_dir
    chunks, targets, lengths = load_numpy_datasets(
        directory, limit=args.chunks)

    epochs = [int(w) for w in str(args.weights).split(",")]
    poas: list[list[str]] = []
    refs = None
    for w in epochs:
        print(f"* loading model {w}", file=sys.stderr)
        model, cfg = load_model(args.model_directory, device=args.device,
                                weights=w or None)
        dev = next(model.parameters()).device

        print("* calling", file=sys.stderr)
        t0 = time.perf_counter()
        seqs = []
        batch_refs_all = []
        with torch.inference_mode(), on_device(dev):
            for start in range(0, len(lengths), args.batchsize):
                c = np.asarray(chunks[start:start + args.batchsize],
                               np.float32)
                t = targets[start:start + args.batchsize]
                l = lengths[start:start + args.batchsize]
                n_real = len(c)
                if n_real < args.batchsize:  # pad: one batch shape
                    pad = np.zeros((args.batchsize - n_real, c.shape[1]),
                                   c.dtype)
                    c = np.concatenate([c, pad])
                scores = loop.eval_scores(model, torch.from_numpy(c).to(dev))
                seqs.extend(model.decode_batch(scores[:, :n_real]))
                batch_refs_all.extend(
                    decode_codes(row[:ln], cfg.alphabet)
                    for row, ln in zip(t, l))
        duration = time.perf_counter() - t0
        if refs is None:
            refs = batch_refs_all

        accuracies = [
            accuracy(ref, seq, min_coverage=args.min_coverage)
            if len(seq) else 0.
            for ref, seq in zip(refs, seqs)
        ]
        if args.poa:
            poas.append(seqs)

        print("* mean      %.2f%%" % np.mean(accuracies))
        print("* median    %.2f%%" % np.median(accuracies))
        print("* time      %.2f" % duration)
        print("* samples/s %.2E" % (len(lengths) * chunks.shape[1]
                                    / duration))

    if args.poa and len(poas) > 1:
        from xna_basecaller_tpu_torch.utils.poa import poa

        print("* doing poa", file=sys.stderr)
        t0 = time.perf_counter()
        groups = [list(seq) for seq in zip(*poas)]  # per-chunk across models
        consensuses = poa(groups)
        duration = time.perf_counter() - t0
        accuracies = [
            accuracy(ref, seq, min_coverage=args.min_coverage)
            if len(seq) else 0.
            for ref, seq in zip(refs, consensuses)
        ]
        print("* poa mean      %.2f%%" % np.mean(accuracies))
        print("* poa median    %.2f%%" % np.median(accuracies))
        print("* poa time      %.2f" % duration)


def argparser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    parser.add_argument("model_directory")
    parser.add_argument("--directory", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    parser.add_argument("--batchsize", default=96, type=int)
    parser.add_argument("--chunks", default=1000, type=int)
    parser.add_argument("--weights", default="0", type=str,
                        help="comma-separated checkpoint epochs")
    parser.add_argument("--seed", default=9, type=int)
    parser.add_argument("--min-coverage", default=0.5, type=float)
    parser.add_argument("--poa", action="store_true",
                        help="POA consensus across the evaluated "
                             "checkpoints (the reference's intended "
                             "--poa; its own crashes, evaluate.py:84)")
    return parser
