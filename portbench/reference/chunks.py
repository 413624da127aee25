"""Chunking and stitching of a read, as bonito's ``util.py`` does it
(``chunk``, ``stitch``: lines 152-188 there), frozen here: the read is cut
into windows of ``chunksize`` with ``overlap`` samples shared, the first
window ending at the stub; the stitched read keeps, of each window's
frames, those outside half the overlap.
"""

from __future__ import annotations

import numpy as np


def chunk(signal: np.ndarray, chunksize: int, overlap: int) -> np.ndarray:
    """[n_chunks, chunksize]; a read shorter than a chunk is left-padded."""
    T = len(signal)
    if T < chunksize:
        return np.pad(signal, (chunksize - T, 0))[None, :]
    stub = (T - overlap) % (chunksize - overlap)
    starts = np.arange(stub, T - chunksize + 1, chunksize - overlap)
    chunks = np.stack([signal[s:s + chunksize] for s in starts])
    if stub > 0:
        chunks = np.concatenate([signal[None, :chunksize], chunks])
    return chunks


def kept_frames(n_chunks: int, length: int, chunksize: int, overlap: int,
                stride: int) -> list[tuple[int, int]]:
    """For each chunk, the [start, end) of its frames that the stitched
    read keeps, in order (forward strand)."""
    frames = chunksize // stride
    if n_chunks == 1:
        return [(0, frames)]
    semi = overlap // 2
    start, end = semi // stride, (chunksize - semi) // stride
    stub = (length - overlap) % (chunksize - overlap)
    first_end = (stub + semi) // stride if stub > 0 else end
    return ([(0, first_end)] + [(start, end)] * (n_chunks - 2)
            + [(start, frames)])
