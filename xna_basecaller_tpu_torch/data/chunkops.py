"""Copied from ``xna_basecaller_tpu/data/chunkops.py``;
only the package imports differ.

Chunk / stitch / batchify: the long-signal mechanism.

Reads of arbitrary length are split into fixed overlapping windows, decoded
independently (embarrassingly parallel — the TPU batch axis), and stitched
back by trimming semi-overlap margins.  The index arithmetic replicates the
reference exactly (reference: ub-bonito/bonito/util.py:152-225), since decode
parity depends on it; the implementation is host-side numpy feeding
fixed-shape device batches.
"""

from __future__ import annotations

import numpy as np


def chunk(signal: np.ndarray, chunksize: int, overlap: int) -> np.ndarray:
    """Split a 1-D signal into overlapping chunks [n_chunks, chunksize].

    Replicates reference util.py:152-166: left-pad short signals; when a
    remainder ("stub") exists, the first window covers signal[:chunksize]
    and subsequent windows start at the stub offset.
    """
    signal = np.asarray(signal)
    T = signal.shape[0]
    if chunksize == 0:
        return signal[None, :]
    if T < chunksize:
        return np.pad(signal, (chunksize - T, 0))[None, :]
    stub = (T - overlap) % (chunksize - overlap)
    step = chunksize - overlap
    starts = np.arange(stub, T - chunksize + 1, step)
    chunks = np.stack([signal[s:s + chunksize] for s in starts])
    if stub > 0:
        chunks = np.concatenate([signal[None, :chunksize], chunks], axis=0)
    return chunks


def _concat(xs, dim=0):
    """Type-agnostic concat (reference util.py:66-81)."""
    if isinstance(xs[0], np.ndarray):
        return np.concatenate(xs, axis=dim)
    if isinstance(xs[0], list):
        return [x for l in xs for x in l]
    if isinstance(xs[0], str):
        return "".join(xs)
    if isinstance(xs[0], dict):
        return {k: _concat([x[k] for x in xs], dim) for k in xs[0].keys()}
    raise TypeError(type(xs[0]))


def stitch(chunks, chunksize: int, overlap: int, length: int, stride: int,
           reverse: bool = False):
    """Stitch per-chunk results back into one read.

    Replicates reference util.py:169-188: drop semi-overlap margins from
    interior chunks; the first chunk keeps up to the stub boundary; handles
    reverse-strand chunk ordering.
    """
    chunks = np.asarray(chunks) if not isinstance(chunks, (list, dict)) \
        else chunks
    if isinstance(chunks, dict):
        return {k: stitch(v, chunksize, overlap, length, stride, reverse)
                for k, v in chunks.items()}
    if len(chunks) == 1:
        return chunks[0]

    semi_overlap = overlap // 2
    start, end = semi_overlap // stride, (chunksize - semi_overlap) // stride
    stub = (length - overlap) % (chunksize - overlap)
    first_chunk_end = (stub + semi_overlap) // stride if (stub > 0) else end

    if reverse:
        chunks = list(chunks)
        return _concat([
            chunks[-1][:-start],
            *(x[-end:-start] for x in reversed(chunks[1:-1])),
            chunks[0][-first_chunk_end:],
        ])
    return _concat([
        chunks[0][:first_chunk_end],
        *(x[start:end] for x in chunks[1:-1]),
        chunks[-1][start:],
    ])


def _batch_pieces(items, batchsize: int):
    """Flatten (key, rows) pairs into pieces that never straddle a batch
    boundary, tagging each with its (start, end) slot in the batch."""
    pos = 0
    for key, rows in items:
        taken = 0
        while taken < len(rows):
            take = min(batchsize - pos, len(rows) - taken)
            yield key, rows[taken:taken + take], pos, pos + take
            taken += take
            pos = (pos + take) % batchsize


def batchify(items, batchsize: int):
    """Re-pack (key, array) pairs into fixed-size batches.

    Yields (sub_batches, batch) where sub_batches is a tuple of
    (key, (start, end)) locating each key's rows inside the batch — the
    same output contract as reference util.py:191-210 (decode parity
    depends on the batch layout).  The final short batch is yielded
    as-is; callers pad it to the fixed shape before hitting the device.
    """
    keys: list = []
    parts: list = []
    for key, piece, start, end in _batch_pieces(items, batchsize):
        keys.append((key, (start, end)))
        parts.append(piece)
        if end == batchsize:
            yield tuple(keys), _concat(parts, 0)
            keys, parts = [], []
    if parts:
        yield tuple(keys), _concat(parts, 0)


def unbatchify(batches):
    """Reassemble per-key results from batches by merging consecutive
    pieces of the same key (output contract of reference util.py:213-225)."""
    current = None
    acc: list = []
    for sub_batches, batch in batches:
        for key, (start, end) in sub_batches:
            piece = _select(batch, start, end)
            if key == current:
                acc.append(piece)
                continue
            if current is not None:
                yield current, _concat(acc, 0)
            current, acc = key, [piece]
    if current is not None:
        yield current, _concat(acc, 0)


def _select(v, start, end):
    if isinstance(v, dict):
        return {k: _select(x, start, end) for k, x in v.items()}
    return v[start:end]
