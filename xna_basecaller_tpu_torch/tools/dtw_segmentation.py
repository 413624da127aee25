"""Copied from ``xna_basecaller_tpu/tools/dtw_segmentation.py``; only
the package imports differ, and the ``n_proc`` worker pool starts its
processes by spawning (this package's callers hold threads and CUDA state,
which a forked child must not inherit).

Offline per-base signal segmentation via DTW -> breakpoints.npy.

Re-implements the reference tool (reference: src/tools/dtw_segmentation.py):
simulate the per-base reference squiggle from the k-mer pore model, DTW-align
each chunk to it with an asymmetric step pattern that FORBIDS reference
skips (dtw_segmentation.py:168-170: query advances every step; reference
either stays or advances with it), with the reference repeated ``ref_rep``
times to enforce a minimum dwell; per-base sample counts come from the
matched reference indices, cumulative-summed into breakpoints
(dtw_segmentation.py:195-202).  DTW failure (impossible warping) falls back
to uniform/naive segmentation (dtw_segmentation.py:183-191).

The DP replaces the external dtw-python C core with a vectorised numpy
recursion: D[i, j] = d[i, j] + min(D[i-1, j], D[i-1, j-1]) — exactly the
custom step pattern's reachable set — with an optional slanted band.
"""

from __future__ import annotations

import os
from functools import partial
import multiprocessing

import numpy as np

from xna_basecaller_tpu_torch.core.alphabet import BASES, CODE, decode
from xna_basecaller_tpu_torch.data.ctc_data import atomic_np_save
from xna_basecaller_tpu_torch.data.pore_model import (
    PoreModel, load_pore_model,
)
from xna_basecaller_tpu_torch.data.simulate import med_mad
from xna_basecaller_tpu_torch.utils import native

_BIG = np.float32(3.0e38)


def reference_squiggle(target_codes, pore: PoreModel) -> np.ndarray:
    """Per-base normalised level track for a target (one level per base)."""
    seq = decode(target_codes, BASES, drop_blank=False)
    means, stds = pore.seq_levels(seq, append=True)
    means = np.asarray(means[: len(seq)], np.float32)
    # normalise like the reference's squiggly med/MAD (uniform event noise
    # has no effect on the expected median of the means track)
    med, mad = med_mad(means)
    return (means - med) / mad


def dtw_band_align(query: np.ndarray, ref: np.ndarray,
                   band: int | None = None):
    """Monotone no-ref-skip DTW; returns per-query ref indices.

    Steps allowed per query sample: stay on ref j or advance to j+1.  The
    path starts at (0, 0) and ends at (T-1, R-1); every ref element is
    visited (no skips).  Returns None if T < R (no feasible path).
    """
    T, R = len(query), len(ref)
    if T < R:
        return None
    if native.available():
        return native.dtw_band(query, ref, band)
    d = np.abs(query[:, None].astype(np.float32)
               - ref[None, :].astype(np.float32))
    if band is not None:
        slope = R / T
        centers = (np.arange(T) * slope)[:, None]
        mask = np.abs(np.arange(R)[None, :] - centers) > band
        d = np.where(mask, _BIG, d)
    D = np.full(R, _BIG, np.float32)
    D[0] = d[0, 0]
    came_diag = np.zeros((T, R), bool)
    for i in range(1, T):
        stay = D
        diag = np.concatenate(([np.float32(_BIG)], D[:-1]))
        choose_diag = diag < stay
        came_diag[i] = choose_diag
        D = d[i] + np.where(choose_diag, diag, stay)
    if not np.isfinite(D[R - 1]) or D[R - 1] >= _BIG:
        return None
    # traceback
    idx = np.empty(T, np.int32)
    j = R - 1
    for i in range(T - 1, -1, -1):
        idx[i] = j
        if came_diag[i, j]:
            j -= 1
    if j != -1 and not (j == 0 and idx[0] == 0):
        # path failed to consume all of ref from the start
        return None
    return idx


def naive_breakpoints(chunksize: int, length: int) -> np.ndarray:
    """Uniform dwell fallback (reference dtw_segmentation.py:187-191)."""
    reps = np.full(length, chunksize // length)
    reps[: chunksize % length] += 1
    return np.cumsum(reps)


def segment_read(chunk, length, target, pore: PoreModel, ref_rep: int = 3,
                 window_size: float | None = None,
                 ubs_map=None) -> tuple[np.ndarray, bool]:
    """Breakpoints for one chunk (reference segment_read,
    dtw_segmentation.py:128-202)."""
    length = int(length)
    target = np.asarray(target[:length]).astype(np.int64)
    if ubs_map is not None:
        target = target.copy()
        target[target == 5] = CODE[ubs_map[0]]
        target[target == 6] = CODE[ubs_map[1]]
    chunk = np.asarray(chunk, np.float32)
    T = chunk.shape[-1]

    ref = reference_squiggle(target, pore)
    ref_full = np.repeat(ref, ref_rep)

    band = None
    if window_size is not None:
        band = (T / length) * window_size

    idx = dtw_band_align(chunk, ref_full, band=band)
    if idx is None:
        return naive_breakpoints(T, length), False
    base_idx = idx // ref_rep
    reps = np.bincount(base_idx, minlength=length)
    return np.cumsum(reps).astype(np.int64), True


def _star_segment(args, **kw):
    return segment_read(*args, **kw)


def dtw_segmentation(ctc_dir: str, ref_rep: int = 3,
                     window_size: float | None = None,
                     pore_model_path: str | None = None, ubs_map=None,
                     naive: bool = False, n_proc: int = 0,
                     overwrite: bool = False, suffix: str | None = None,
                     limit: int | None = None, log=print):
    """Produce breakpoints.npy for a ctc-data directory (reference
    dtw_segmentation, dtw_segmentation.py:207-292)."""
    out_name = "breakpoints" if not naive else "breakpoints-naive"
    out_name += ".npy" if suffix is None else f"-{suffix}.npy"
    out_path = os.path.join(ctc_dir, out_name)
    if os.path.exists(out_path) and not overwrite:
        log(f"[WARNING] Skipping, output exists: {out_path}")
        return None, None

    chunks = np.load(os.path.join(ctc_dir, "chunks.npy"), mmap_mode="r")
    targets = np.load(os.path.join(ctc_dir, "references.npy"))
    lengths = np.load(os.path.join(ctc_dir, "reference_lengths.npy"))
    if limit:
        targets = targets[:limit]
        lengths = lengths[:limit]

    if naive:
        T = chunks.shape[-1]
        results = [(naive_breakpoints(T, int(l)), True) for l in lengths]
    else:
        pore = load_pore_model(pore_model_path)
        kw = dict(pore=pore, ref_rep=ref_rep, window_size=window_size,
                  ubs_map=ubs_map)
        items = [(np.asarray(chunks[i], np.float32), lengths[i], targets[i])
                 for i in range(len(lengths))]
        if n_proc and n_proc > 1:
            with multiprocessing.get_context("spawn").Pool(n_proc) as pool:
                results = pool.map(partial(_star_segment, **kw), items,
                                   chunksize=8)
        else:
            results = [segment_read(*it, **kw) for it in items]

    bkps = np.zeros_like(targets, dtype=np.uint16)
    ok = []
    for i, (bk, success) in enumerate(results):
        bkps[i, : len(bk)] = np.minimum(bk, np.iinfo(np.uint16).max)
        ok.append(success)
    # breakpoints.npy gates the whole bootstrap-data phase in the
    # resumable chains — must never exist truncated
    atomic_np_save(out_path, bkps)
    log(f"Saved {out_path} ({np.sum(ok)}/{len(ok)} DTW-aligned)")
    return bkps, np.asarray(ok)
