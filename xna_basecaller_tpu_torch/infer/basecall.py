"""Basecalling pipeline: raw reads -> chunk -> batch -> score+decode -> stitch.

Port of ``xna_basecaller_tpu/infer/basecall.py`` (``basecall``,
``run_basecaller``):

* Host stages (chunking, batch packing, stitching) run in background
  threads over bounded queues; every batch is padded to one fixed
  (batchsize, chunksize) shape.
* The upload stage sends the batch as f16 (f32 in the f32 parity mode;
  with ``quantize``, the int8 codes ``round(sig * QUANT_SCALE)``) from
  pinned memory; the compute stage runs the model and the decode on the
  device; the fetch stage brings back only the int8 label paths [N, T']
  with ``.cpu()``.  All device work goes to one CUDA stream, the
  device's default stream, so the stages need no other synchronisation.
* The decode on a CUDA tensor runs the kernels of ``ops/crf_cuda.py``; on
  a CPU tensor the plain ``ops/crf.py::decode_paths``.
* Stitching is frame-accurate by default; ``legacy_char_stitch=True``
  stitches left-packed label arrays, as the reference UB path does.
* R-strand decoding reverse-complements the scores on the device and
  stitches with reverse=True; ``ub_bias`` is added after the reverse
  complement and before the decode.
* ``quantize`` is the int8 path of ``--quantize``: the int8 upload, int8
  input projections and CRF head, and the int8 recurrence K7
  (``Model.forward(lstm_int8=True)``).
* ``model`` may be a list of models of one architecture, a checkpoint
  ensemble (``_forward``, JAX's ``_apply_maybe_ensemble``): each batch goes
  through every member on the device and the decode runs on the mean of
  their f32 scores.

Not ported yet: q-scores, the beam decoder and superbatches.
"""

from __future__ import annotations

from time import perf_counter
from typing import Iterable, Iterator

import numpy as np
import torch

from xna_basecaller_tpu_torch.data import chunkops
from xna_basecaller_tpu_torch.models.crf_model import QUANT_SCALE
from xna_basecaller_tpu_torch.ops import crf as crf_ops
from xna_basecaller_tpu_torch.ops.crf_cuda import decode_paths_cuda
from xna_basecaller_tpu_torch.utils.pipeline import (
    ordered_thread_map, thread_iter,
)


def _apply_ub_bias(scores: torch.Tensor, n_base: int, ub_bias: float):
    """Add ``ub_bias`` to every transition score whose emitted label is a
    UB (label index > 4 in the NACGTXY alphabet).  No-op at 0.0."""
    if not ub_bias:
        return scores
    T, N, C = scores.shape
    bias = scores.new_zeros(n_base + 1)
    bias[5:] = ub_bias
    return (scores.reshape(T, N, C // (n_base + 1), n_base + 1)
            + bias).reshape(T, N, C)


def _score_and_decode(scores: torch.Tensor, n_base: int, state_len: int,
                      reverse: bool = False, ub_bias: float = 0.0):
    """CRF scores [T', N, C] -> per-frame label paths [N, T'] int8."""
    if reverse:
        scores = crf_ops.reverse_complement(scores, n_base, state_len)
    scores = _apply_ub_bias(scores, n_base, ub_bias)
    decode = decode_paths_cuda if scores.is_cuda else crf_ops.decode_paths
    return decode(scores, n_base, state_len)


def _forward(models, batch: torch.Tensor, compute_dtype, lstm_int8: bool):
    """The f32 CRF scores of one batch: of the model, or for a list of
    models the MEAN of the members' scores, summed in member order and
    divided by their count, as ``infer/basecall.py::_apply_maybe_ensemble``
    of the JAX package does (a product of the members' CRF distributions;
    their logZ offsets are per-sample constants, so the Viterbi path is
    that of the normalised mean)."""
    members = models if isinstance(models, (list, tuple)) else (models,)
    sc = members[0](batch, compute_dtype=compute_dtype, lstm_int8=lstm_int8)
    for m in members[1:]:
        sc = sc + m(batch, compute_dtype=compute_dtype, lstm_int8=lstm_int8)
    return sc / len(members) if len(members) > 1 else sc


def _pad_batch(batch: np.ndarray, batchsize: int) -> tuple[np.ndarray, int]:
    n = len(batch)
    if n == batchsize:
        return batch, n
    pad = np.zeros((batchsize - n,) + batch.shape[1:], batch.dtype)
    return np.concatenate([batch, pad], axis=0), n


def basecall(model, reads: Iterable, chunksize: int = 3600,
             overlap: int = 500, batchsize: int = 256,
             reverse: bool = False, compute_dtype=torch.bfloat16,
             legacy_char_stitch: bool = False, cancel=None,
             stitch_workers: int = 4, ub_bias: float = 0.0,
             quantize: bool = False) -> Iterator:
    """Basecall reads lazily on the model's device; yields (read, attrs).

    ``model`` is a model or a list of models of one architecture on one
    device (an ensemble: the decode runs on the mean of their scores).
    ``reads`` yield objects with ``.signal`` (1-D float32) and ``.read_id``.
    ``cancel`` (a threading.Event) stops the read producer early.
    ``quantize`` uploads ``clip(rint(sig * QUANT_SCALE), -127, 127)`` as
    int8 and runs the model's int8 path (``lstm_int8=True``)."""
    members = model if isinstance(model, (list, tuple)) else [model]
    model = members[0]
    device = next(model.parameters()).device
    stride = model.stride
    up_dtype = np.int8 if quantize else (
        np.float32 if compute_dtype == torch.float32 else np.float16)
    n_base, state_len = model.seqdist.n_base, model.seqdist.state_len

    def gen_chunks():
        for read in reads:
            if cancel is not None and cancel.is_set():
                return
            sig = np.asarray(read.signal, dtype=np.float32)
            yield ((read, 0, len(sig)),
                   chunkops.chunk(sig, chunksize, overlap))

    chunks = thread_iter(gen_chunks())
    batches = thread_iter(chunkops.batchify(iter(chunks), batchsize))

    def gen_uploads():
        for keys, batch in batches:
            padded, n = _pad_batch(np.asarray(batch), batchsize)
            if quantize:
                padded = np.clip(np.rint(padded * QUANT_SCALE), -127, 127)
            host = torch.from_numpy(np.ascontiguousarray(padded, up_dtype))
            if device.type == "cuda":
                host = host.pin_memory()
            yield keys, n, host.to(device, non_blocking=True)

    uploads = thread_iter(gen_uploads(), maxsize=3)

    def gen_compute():
        # enqueues the device work without waiting for it; the fetch
        # stage's .cpu() waits for each batch's labels
        with torch.inference_mode():
            for keys, n, dev in uploads:
                scores = _forward(members, dev, compute_dtype, quantize)
                yield keys, n, _score_and_decode(
                    scores, n_base, state_len, reverse, float(ub_bias))

    computed = thread_iter(gen_compute(), maxsize=3)

    def gen_fetch():
        for keys, n, paths in computed:
            yield keys, {"path": paths[:n].cpu().numpy()}

    fetched = thread_iter(gen_fetch())

    def finish(item):
        (read, start, end), attrs = item
        path = attrs["path"]  # [n_chunks, T']
        if legacy_char_stitch:
            path = _left_pack(path)
        stitched = chunkops.stitch(path, chunksize, overlap, end - start,
                                   stride, reverse=reverse)
        seq = model.seqdist.path_to_str(stitched)
        return read, {
            "sequence": seq,
            # the reference UB path's dummy mid-scale qstring
            # (crf/basecall.py:67)
            "qstring": "O" * len(seq),
            "moves": np.asarray(stitched) != 0,
            "stride": stride,
        }

    return ordered_thread_map(
        finish, chunkops.unbatchify(fetched), n_workers=stitch_workers,
        maxsize=4)


def _left_pack(paths: np.ndarray) -> np.ndarray:
    """Left-pack nonzero labels per chunk (reference crf/basecall.py:58-70):
    the decoded string's codes padded with zeros to frame length."""
    order = np.argsort(paths == 0, axis=1, kind="stable")
    return np.take_along_axis(paths, order, axis=1)


def run_basecaller(model, reads, fastq_out, summary_out=None,
                   chunksize: int = 3600, overlap: int = 500,
                   batchsize: int = 256, reverse: bool = False,
                   quantize: bool = False, **basecall_opts) -> dict:
    """Drive the full pipeline, writing FASTQ (+ summary); returns timing
    stats with the headline samples/s.  ``quantize`` runs the int8 path;
    extra keyword options (e.g. ``legacy_char_stitch``, ``compute_dtype``,
    ``ub_bias``) go to :func:`basecall`."""
    t0 = perf_counter()
    n_reads = 0
    n_samples = 0
    for read, attrs in basecall(
            model, reads, chunksize=chunksize, overlap=overlap,
            batchsize=batchsize, reverse=reverse, quantize=quantize,
            **basecall_opts):
        n_reads += 1
        n_samples += len(read.signal)
        fastq_out.write(
            f"@{read.read_id}\n{attrs['sequence']}\n+\n{attrs['qstring']}\n")
        if summary_out is not None:
            summary_out.write(
                f"{read.read_id}\t{len(read.signal)}\t"
                f"{len(attrs['sequence'])}\n")
    dt = perf_counter() - t0
    return {
        "reads": n_reads,
        "samples": n_samples,
        "seconds": dt,
        "samples_per_s": n_samples / dt if dt > 0 else 0.0,
    }
