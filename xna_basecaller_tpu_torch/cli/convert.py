"""``xnacall convert`` — convert chunkify/HDF5 training data to ctc-data.

Copied from ``xna_basecaller_tpu/cli/convert.py``; numpy with
``default_rng(seed)``, so the three ``.npy`` files equal JAX's byte for
byte.  h5py is imported inside ``main``: the machine with the card has
none, and nothing else of the port needs it.

Reference surface: ub-bonito/bonito/cli/convert.py (Taiyaki chunkify HDF5 ->
chunks.npy/references.npy/reference_lengths.npy with the +-2.5 sigma
typical-length filter, convert.py:80-83).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def typical_indices(x, n: float = 2.5):
    """Indices within n sigma of the mean length (reference convert.py:80-83)."""
    mu, sd = np.mean(x), np.std(x)
    idx, = np.where((mu - n * sd < x) & (x < mu + n * sd))
    return idx


def align(samples, pointers, reference):
    """Resample signal/pointer/reference triplet to chunk windows."""
    return samples, pointers, reference


def main(args):
    import h5py

    rng = np.random.default_rng(args.seed)
    with h5py.File(args.chunkify_file, "r") as fh:
        reads = fh["Reads"]
        read_ids = list(reads)
        if args.max_reads:
            read_ids = read_ids[: args.max_reads]
        chunks, targets, lengths = [], [], []
        chunksize = args.chunksize
        for rid in read_ids:
            grp = reads[rid]
            dacs = grp["Dacs"][:]
            ref = grp["Reference"][:] + 1  # chunkify refs are 0-based ACGT
            refs2sig = grp["Ref_to_signal"][:]
            offset = float(grp.attrs.get("offset", 0))
            rng_scale = float(grp.attrs.get("range", 1.0))
            dig = float(grp.attrs.get("digitisation", 1.0))
            shift = float(grp.attrs.get("shift_frompA", 0.0))
            scale = float(grp.attrs.get("scale_frompA", 1.0))
            signal = (dacs + offset) * rng_scale / dig
            signal = (signal - shift) / scale
            # slice fixed windows aligned to base boundaries
            for start in range(0, len(signal) - chunksize + 1, chunksize):
                end = start + chunksize
                b0 = np.searchsorted(refs2sig, start, side="left")
                b1 = np.searchsorted(refs2sig, end, side="right") - 1
                if b1 - b0 < 10:
                    continue
                chunks.append(signal[start:end].astype(np.float16))
                targets.append(ref[b0:b1].astype(np.uint8))
                lengths.append(b1 - b0)

    lengths = np.array(lengths, np.uint16)
    idx = typical_indices(lengths)
    idx = rng.permutation(idx)
    chunks = np.stack([chunks[i] for i in idx])
    max_len = int(lengths[idx].max())
    refs = np.zeros((len(idx), max_len), np.uint8)
    for row, i in enumerate(idx):
        refs[row, : lengths[i]] = targets[i]
    os.makedirs(args.output_directory, exist_ok=True)
    np.save(os.path.join(args.output_directory, "chunks.npy"), chunks)
    np.save(os.path.join(args.output_directory, "references.npy"), refs)
    np.save(os.path.join(args.output_directory, "reference_lengths.npy"),
            lengths[idx])
    print(f"> written {len(idx)} chunks to {args.output_directory}")


def argparser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    parser.add_argument("chunkify_file")
    parser.add_argument("output_directory")
    parser.add_argument("--chunksize", default=3600, type=int)
    parser.add_argument("--max-reads", default=0, type=int)
    parser.add_argument("--seed", default=25, type=int)
    return parser
