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
  (and with ``qscores`` the f16 posteriors of their transitions) with
  ``.cpu()``.  All device work goes to one CUDA stream, the device's
  default stream, so the stages need no other synchronisation.
* The decode on a CUDA tensor runs the kernels of ``ops/crf_cuda.py``; on
  a CPU tensor their plain versions in ``ops/crf.py``: the Viterbi decode,
  or with ``qscores`` the decode that also gives the posterior of each
  chosen transition (``decode_paths_with_qual``: real per-base qualities,
  ``phred`` with the model's ``[qscore]`` scale and bias, vectorised in
  ``data/writers.py::qstring``), or with ``beam_width > 0`` the path-collapsing beam decode
  (``decode_beam``).
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

* ``superbatch = G > 1`` (JAX's ``_super_forward_decode``,
  ``infer/basecall.py:127-150, 229-262`` there): G padded batches go up as
  one [G, N, T] upload, and their sub-batches run in order through the
  model and the Viterbi decode, so that one sub-batch's [T, N, C] f32
  scores is live at a time.  The trailing group is padded with empty
  batches (n = 0), so that every upload has one shape; unlike JAX, which
  computes them, they are skipped (K1 runs 5 times and K2a/b/c once per
  real batch, whatever G).  The calls equal G = 1's.  With ``qscores`` or
  a beam, G runs as 1, with JAX's warning.
"""

from __future__ import annotations

import sys
from time import perf_counter
from typing import Iterable, Iterator

import numpy as np
import torch

from xna_basecaller_tpu_torch.data import chunkops
from xna_basecaller_tpu_torch.data.writers import qstring
from xna_basecaller_tpu_torch.models.crf_model import QUANT_SCALE
from xna_basecaller_tpu_torch.ops import crf as crf_ops
from xna_basecaller_tpu_torch.ops.crf_cuda import (
    decode_beam_cuda, decode_paths_cuda, decode_paths_with_qual_cuda,
)
from xna_basecaller_tpu_torch.utils.device import on_device
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


def _score_and_decode_qual(scores: torch.Tensor, n_base: int,
                           state_len: int, reverse: bool = False,
                           ub_bias: float = 0.0):
    """The decode with the posterior of each chosen transition: (paths
    [N, T'] int8, probs [N, T'] f16), as JAX's ``_score_and_decode_qual``."""
    if reverse:
        scores = crf_ops.reverse_complement(scores, n_base, state_len)
    scores = _apply_ub_bias(scores, n_base, ub_bias)
    paths, probs = decode_paths_with_qual_cuda(scores, n_base, state_len)
    return paths, probs.half()


def _score_and_decode_beam(scores: torch.Tensor, n_base: int,
                           state_len: int, beam_width: int,
                           reverse: bool = False, ub_bias: float = 0.0):
    """The path-collapsing beam decode: paths [N, T'] int8, as JAX's
    ``_score_and_decode_beam``."""
    if reverse:
        scores = crf_ops.reverse_complement(scores, n_base, state_len)
    scores = _apply_ub_bias(scores, n_base, ub_bias)
    return decode_beam_cuda(scores, n_base, state_len, beam_width)[0]


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
             legacy_char_stitch: bool = False, qscores: bool = False,
             cancel=None, stitch_workers: int = 4, quantize: bool = False,
             beam_width: int = 0, superbatch: int = 1,
             ub_bias: float = 0.0) -> Iterator:
    """Basecall reads lazily on the model's device; yields (read, attrs).

    ``model`` is a model or a list of models of one architecture on one
    device (an ensemble: the decode runs on the mean of their scores).
    ``reads`` yield objects with ``.signal`` (1-D float32) and ``.read_id``.
    ``qscores`` emits real per-base qualities from the Viterbi edge
    posteriors; ``beam_width > 0`` decodes with the path-collapsing beam
    search instead of Viterbi (``qscores`` wins where both are set, as in
    JAX).  ``superbatch`` G > 1 uploads G batches at once and runs them
    one after another; together with ``qscores`` or a beam it runs as 1,
    with JAX's warning.
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
    G = max(1, int(superbatch))
    if G > 1 and (qscores or beam_width > 0):
        print(f"[basecall] --superbatch {superbatch} ignored (runs as 1): "
              "qscores/beam decoding is not superbatched", file=sys.stderr)
        G = 1

    def gen_chunks():
        for read in reads:
            if cancel is not None and cancel.is_set():
                return
            sig = np.asarray(read.signal, dtype=np.float32)
            yield ((read, 0, len(sig)),
                   chunkops.chunk(sig, chunksize, overlap))

    chunks = thread_iter(gen_chunks())
    batches = thread_iter(chunkops.batchify(iter(chunks), batchsize))

    def upload(group):
        """One [G, N, T] upload of a group of padded batches."""
        host = torch.from_numpy(np.stack([a for _, _, a in group]))
        if device.type == "cuda":
            host = host.pin_memory()
        return ([k for k, _, _ in group], [n for _, n, _ in group],
                host.to(device, non_blocking=True))

    def gen_uploads():
        group = []
        for keys, batch in batches:
            padded, n = _pad_batch(np.asarray(batch), batchsize)
            if quantize:
                padded = np.clip(np.rint(padded * QUANT_SCALE), -127, 127)
            group.append((keys, n, np.asarray(padded, up_dtype)))
            if len(group) == G:
                yield upload(group)
                group = []
        if group:
            # the trailing group padded with empty batches (n = 0): one
            # upload shape; they are not computed
            empty = np.zeros_like(group[0][2])
            yield upload(group + [((), 0, empty)] * (G - len(group)))

    uploads = thread_iter(gen_uploads(), maxsize=3)

    def gen_compute():
        # enqueues the device work without waiting for it; the fetch
        # stage's .cpu() waits for each batch's labels.  A group's
        # sub-batches run in order, one sub-batch's scores live at a time.
        # The kernels launch on this thread's current device: the model's.
        with torch.inference_mode(), on_device(device):
            for keys_g, n_g, dev in uploads:
                outs = []
                for keys, n, x in zip(keys_g, n_g, dev):
                    if not keys:
                        continue
                    scores = _forward(members, x, compute_dtype, quantize)
                    probs = None
                    if qscores:
                        paths, probs = _score_and_decode_qual(
                            scores, n_base, state_len, reverse,
                            float(ub_bias))
                    elif beam_width > 0:
                        paths = _score_and_decode_beam(
                            scores, n_base, state_len, beam_width, reverse,
                            float(ub_bias))
                    else:
                        paths = _score_and_decode(
                            scores, n_base, state_len, reverse,
                            float(ub_bias))
                    del scores
                    outs.append((keys, n, paths, probs))
                yield outs

    computed = thread_iter(gen_compute(), maxsize=3)

    def gen_fetch():
        for outs in computed:
            for keys, n, paths, probs in outs:
                out = {"path": paths[:n].cpu().numpy()}
                if probs is not None:
                    out["prob"] = probs[:n].cpu().numpy().astype(np.float32)
                yield keys, out

    fetched = thread_iter(gen_fetch())

    def finish(item):
        (read, start, end), attrs = item
        path = attrs["path"]  # [n_chunks, T']
        if legacy_char_stitch:
            path = _left_pack(path)
        stitched = chunkops.stitch(path, chunksize, overlap, end - start,
                                   stride, reverse=reverse)
        seq = model.seqdist.path_to_str(stitched)
        moves = np.asarray(stitched) != 0
        if "prob" in attrs:
            probs = chunkops.stitch(attrs["prob"], chunksize, overlap,
                                    end - start, stride, reverse=reverse)
            quals = qstring(np.asarray(probs)[moves],
                            scale=model.cfg.qscore.scale,
                            bias=model.cfg.qscore.bias)
        else:
            # the reference UB path's dummy mid-scale qstring
            # (crf/basecall.py:67)
            quals = "O" * len(seq)
        return read, {
            "sequence": seq,
            "qstring": quals,
            "moves": moves,
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
                   quantize: bool = False, beam_width: int = 0,
                   **basecall_opts) -> dict:
    """Drive the full pipeline, writing FASTQ (+ summary); returns timing
    stats with the headline samples/s.  ``quantize`` runs the int8 path,
    ``beam_width > 0`` the beam decode; extra keyword options (e.g.
    ``legacy_char_stitch``, ``compute_dtype``, ``ub_bias``, ``qscores``) go
    to :func:`basecall`."""
    t0 = perf_counter()
    n_reads = 0
    n_samples = 0
    for read, attrs in basecall(
            model, reads, chunksize=chunksize, overlap=overlap,
            batchsize=batchsize, reverse=reverse, quantize=quantize,
            beam_width=beam_width, **basecall_opts):
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
