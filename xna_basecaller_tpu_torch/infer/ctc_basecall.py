"""Legacy CTC basecalling pipeline: chunk -> forward -> stitch scores ->
host decode (greedy / prefix beam search).

Port of ``xna_basecaller_tpu/infer/ctc_basecall.py``: the scores are
stitched at the probability level and each read is decoded whole, so that
the beam search sees the full read.  The host and device stages are
``infer/basecall.py``'s (``read_batches``, ``device_stages``): each fixed
(batchsize, chunksize) batch goes up as f16 from pinned memory, the
QuartzNet forward runs on the model's device, and the log-probs come back
as f16 [N, T', C] (half the bytes); the stitch and the decode run on the
host, on an ordered thread map of ``decode_workers``.

Decode (reference ctc/basecall.py:43-64): a greedy pass always gives the
qstring and the mean qscore; with beamsize > 1 (and no ``qscores``) the
sequence comes from the prefix beam search (native C++, the pure-Python
fallback in ``ops/ctc.py``) and the qstring is '*', as in the reference.
"""

from __future__ import annotations

from time import perf_counter
from typing import Iterable, Iterator

import numpy as np
import torch

from xna_basecaller_tpu_torch.data import chunkops
from xna_basecaller_tpu_torch.infer.basecall import (
    device_stages, read_batches, spanned_stitch,
)
from xna_basecaller_tpu_torch.ops import ctc as ctc_ops
from xna_basecaller_tpu_torch.utils.pipeline import ordered_thread_map


def forward_f16(model, batch: torch.Tensor) -> torch.Tensor:
    """Forward to log-probs, transposed to [N, T', C] f16 for the fetch."""
    return model(batch).transpose(0, 1).half()


def mean_qscore_from_qstring(qstring: str) -> float:
    """Mean error-probability -> phred (reference util.py:80-89)."""
    if not qstring or qstring == "*":
        return 0.0
    err = np.mean([10 ** ((ord(c) - 33) / -10) for c in qstring])
    return float(-10 * np.log10(max(err, 1e-10)))


def basecall_ctc(model, reads: Iterable, chunksize: int = 3600,
                 overlap: int = 500, batchsize: int = 64,
                 beamsize: int = 5, threshold: float = 1e-3,
                 qscores: bool = False, cancel=None,
                 decode_workers: int = 4) -> Iterator:
    """Basecall reads with a CTC model on its device; yields (read, attrs)
    like the reference generator (ctc/basecall.py:14-29)."""
    cfg = model.cfg
    stride = model.stride
    alphabet = model.alphabet
    device = next(model.parameters()).device

    scores = device_stages(
        read_batches(reads, chunksize, overlap, batchsize, cancel), device,
        batchsize, np.float16, lambda x: {"scores": forward_f16(model, x)})

    def finish(item):
        (read, start, end), attrs = item
        lp = chunkops.stitch(attrs["scores"], chunksize, overlap,
                             end - start, stride)     # [T_read, C]
        path = np.argmax(lp, axis=1)
        prob = np.exp(np.max(lp, axis=1))
        seq, qstring, moves = ctc_ops.collapse_path(
            path, prob, alphabet,
            qscale=cfg.qscore.scale, qbias=cfg.qscore.bias)
        mean_q = mean_qscore_from_qstring(qstring)
        if beamsize > 1 and not qscores:
            seq_beam, frames = ctc_ops.beam_search(
                np.exp(lp), alphabet, beamsize, threshold)
            if seq_beam:
                seq, qstring = seq_beam, "*"
                moves = np.zeros(len(lp), bool)
                moves[frames] = True
        sig_move = np.zeros(len(moves) * stride, bool)
        sig_move[np.where(moves)[0] * stride] = True
        return read, {
            "sequence": seq,
            "qstring": qstring,
            "mean_qscore": mean_q,
            "moves": moves,
            "sig_move": sig_move,
            "stride": stride,
        }

    return ordered_thread_map(
        spanned_stitch(finish), chunkops.unbatchify(scores),
        n_workers=decode_workers, maxsize=4, name="stitch")


def run_ctc_basecaller(model, reads, fastq_out, beamsize: int = 5,
                       chunksize: int = 3600, overlap: int = 500,
                       batchsize: int = 64) -> dict:
    """Drive the CTC pipeline to FASTQ; returns timing stats."""
    t0 = perf_counter()
    n_reads = n_samples = 0
    for read, attrs in basecall_ctc(model, reads, chunksize, overlap,
                                    batchsize, beamsize):
        n_reads += 1
        n_samples += len(read.signal)
        q = attrs["qstring"] if attrs["qstring"] != "*" \
            else "!" * len(attrs["sequence"])
        fastq_out.write(
            f"@{read.read_id}\n{attrs['sequence']}\n+\n{q}\n")
    dt = perf_counter() - t0
    return {"reads": n_reads, "samples": n_samples, "seconds": dt,
            "samples_per_s": n_samples / dt if dt > 0 else 0.0}
