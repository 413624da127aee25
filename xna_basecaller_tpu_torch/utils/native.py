"""Copied from ``xna_basecaller_tpu/utils/native.py``: the ctypes loader
and the bindings (``levenshtein``, ``sw_align``, ``sw_align_banded``,
``sw_score_batch``, ``lev_demux``, ``dtw_band``, ``ctc_beam_search``,
``poa_consensus``, ``nw_trace``, ``pair_viterbi``).  The library is built into this
package's ``build/`` directory, beside the CUDA kernels (a ``.so`` file
beside the modules would be listed as a Python extension module by
``pkgutil``), through a temporary file renamed into place.

ctypes bindings for the native (C++) host-side kernels.

The shared library (native/xna_native.cpp, outside both packages) replaces
the reference's external native deps — parasail SW, C Levenshtein,
dtw-python core.  It is built on demand with g++ and cached; every
caller has a pure-python/numpy fallback, so a missing toolchain degrades
gracefully.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "xna_native.cpp")
_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "xna_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile to a temporary name and rename it into place, so that a
    process loading the library never sees a half-written file."""
    if not os.path.exists(_SRC):
        return False
    tmp = None
    try:
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=".so",
                                   dir=os.path.dirname(_LIB_PATH))
        os.close(fd)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.levenshtein.restype = ctypes.c_int
        lib.levenshtein.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.sw_align.restype = ctypes.c_int
        lib.sw_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int)]
        lib.sw_score_batch.restype = None
        lib.sw_score_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        lib.lev_demux.restype = ctypes.c_int
        lib.lev_demux.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.sw_align_banded.restype = ctypes.c_int
        lib.sw_align_banded.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int)]
        lib.dtw_band.restype = ctypes.c_int
        lib.dtw_band.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_float,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        lib.ctc_beam_search.restype = ctypes.c_int
        lib.ctc_beam_search.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        lib.nw_trace.restype = ctypes.c_int
        lib.nw_trace.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_longlong]
        lib.pair_viterbi.restype = ctypes.c_int
        lib.pair_viterbi.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_longlong]
        lib.poa_consensus.restype = ctypes.c_int
        lib.poa_consensus.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def levenshtein(a: str, b: str) -> int:
    lib = _load()
    ab, bb = a.encode(), b.encode()
    return lib.levenshtein(ab, len(ab), bb, len(bb))


def sw_align(query: str, ref: str):
    """Native SW; returns (score, cigar [(op, n)], (q0, q1, r0, r1))."""
    return _sw(_load().sw_align, query, ref)


def sw_align_banded(query: str, ref: str, dlo: int, dhi: int):
    """Banded native SW restricted to diagonals j - i in [dlo, dhi].

    Same outputs as sw_align.  Returns None when the native library is
    unavailable (callers fall back to the full-matrix path).  A weak
    score can also mean the true alignment left the band — callers must
    apply their own rescue threshold and re-run sw_align.
    """
    lib = _load()
    if lib is None:
        return None
    return _sw(lib.sw_align_banded, query, ref, int(dlo), int(dhi))


def _sw(fn, query: str, ref: str, *band: int):
    qb, rb = query.encode(), ref.encode()
    bounds = (ctypes.c_int * 4)()
    ops_buf = ctypes.create_string_buffer(len(qb) + len(rb) + 1)
    ops_len = ctypes.c_int(0)
    score = fn(qb, len(qb), rb, len(rb), *band, bounds, ops_buf,
               ctypes.byref(ops_len))
    if score == 0:
        return 0, [], (0, 0, 0, 0)
    ops = ops_buf.raw[: ops_len.value].decode()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return score, [(o, c) for o, c in cigar], tuple(bounds)


def sw_score_batch(query: str, refs: list[str]):
    """Best local SW score of query vs each ref (int32 [n]), or None when
    the native library is unavailable (callers loop sw_align)."""
    lib = _load()
    if lib is None:
        return None
    qb = query.encode()
    flat = "".join(refs).encode()
    offsets = np.zeros(len(refs) + 1, np.int32)
    np.cumsum([len(r) for r in refs], out=offsets[1:])
    out = np.zeros(len(refs), np.int32)
    lib.sw_score_batch(qb, len(qb), flat, offsets, len(refs), out)
    return out


def lev_demux(query: str, candidates: list[str]):
    """(best index, best distance) over candidate strings, or None when
    the native library is unavailable (callers loop levenshtein())."""
    lib = _load()
    if lib is None:
        return None
    qb = query.encode()
    flat = "".join(candidates).encode()
    offsets = np.zeros(len(candidates) + 1, np.int32)
    np.cumsum([len(c) for c in candidates], out=offsets[1:])
    best_d = ctypes.c_int(0)
    idx = lib.lev_demux(qb, len(qb), flat, offsets, len(candidates),
                        ctypes.byref(best_d))
    return idx, best_d.value


def ctc_beam_search(probs: np.ndarray, alphabet: str, beamsize: int = 5,
                    threshold: float = 1e-3):
    """Native CTC prefix beam search; returns (sequence, frames) or None
    if the kernel is unavailable/overflowed (caller falls back to
    ops/ctc.py::_beam_search_py, which defines the semantics)."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(probs, np.float32)
    T, C = p.shape
    seq = np.empty(T + 1, np.int32)
    frames = np.empty(T + 1, np.int32)
    n = lib.ctc_beam_search(p, T, C, int(beamsize), np.float32(threshold),
                            seq, frames, T + 1)
    if n < 0:
        return None
    return ("".join(alphabet[c] for c in seq[:n]),
            frames[:n].astype(np.int64))


def poa_consensus(seqs: list[str]) -> str | None:
    """Native partial-order-alignment consensus of one group; None when
    the library is unavailable (caller falls back to utils/poa.py)."""
    lib = _load()
    if lib is None:
        return None
    blobs = [s.encode() for s in seqs]
    lens = np.array([len(b) for b in blobs], np.int32)
    cap = int(lens.max(initial=0)) * 2 + 16
    out = ctypes.create_string_buffer(cap)
    n = lib.poa_consensus(b"".join(blobs), lens, len(blobs), out, cap)
    if n < 0:
        return None
    return out.raw[:n].decode()


def nw_trace(a: str, b: str, match: int = 5, mismatch: int = -4,
             gap: int = 2, max_cells: int = 256_000_000):
    """Global NW alignment columns as (idx_a, idx_b) int32 [n, 2] in the
    reference envelope's cumsum-1 form (cli/duplex.py:143-148), or None
    when the native library is unavailable or the matrix exceeds
    ``max_cells`` (caller falls back to the numpy oracle / a cap)."""
    lib = _load()
    if lib is None:
        return None
    ab, bb = a.encode(), b.encode()
    pairs = np.empty((len(ab) + len(bb) + 1, 2), np.int32)
    n = lib.nw_trace(ab, len(ab), bb, len(bb), match, mismatch, gap,
                     pairs, pairs.shape[0], max_cells)
    if n < 0:
        return None
    return pairs[:n]


def pair_viterbi(logt1: np.ndarray, logi1: np.ndarray,
                 logt2: np.ndarray, logi2: np.ndarray,
                 env: np.ndarray, n_base: int,
                 max_cells: int = 500_000_000):
    """Envelope-banded exact pair Viterbi (duplex decode core).

    ``logt*`` [T, ns, n_base+1] log transition posteriors, ``logi*`` [ns]
    log initial-state posteriors, ``env`` [T1, 2] int32 strand2 windows.
    Returns (codes 1..n_base int32 [L], strand1 frames int32 [L]) or None
    when the native library is unavailable or the DP exceeds
    ``max_cells`` (caller falls back to the oracle / consensus merge).
    """
    lib = _load()
    if lib is None:
        return None
    t1 = np.ascontiguousarray(logt1, np.float32)
    t2 = np.ascontiguousarray(logt2, np.float32)
    i1 = np.ascontiguousarray(logi1, np.float32)
    i2 = np.ascontiguousarray(logi2, np.float32)
    e = np.ascontiguousarray(env, np.int32)
    T1, ns = t1.shape[:2]
    T2 = t2.shape[0]
    cap = T1 + T2 + 1
    seq = np.empty(cap, np.int32)
    frames = np.empty(cap, np.int32)
    n = lib.pair_viterbi(t1, i1, T1, t2, i2, T2, e, ns, n_base,
                         seq, frames, cap, max_cells)
    if n < 0:
        return None
    return seq[:n], frames[:n]


def dtw_band(query: np.ndarray, ref: np.ndarray,
             band: float | None = None):
    """Native DTW; returns per-query ref indices or None if infeasible."""
    lib = _load()
    q = np.ascontiguousarray(query, np.float32)
    r = np.ascontiguousarray(ref, np.float32)
    out = np.empty(len(q), np.int32)
    rc = lib.dtw_band(q, len(q), r, len(r),
                      np.float32(band if band else 0.0), out)
    if rc != 0:
        return None
    return out
