"""Port of ``xna_basecaller_tpu/infer/pair_decode.py``: the host parts
(``nw_trace_np``, ``nw_columns``, ``build_envelope``,
``pair_viterbi_np``, ``simplex_from_trans``, ``decode_pair``) are copies;
``read_transition_probs`` runs the model's forward in f32, the reverse
complement, ``compute_transition_probs`` (K2a's betas) and the stitch's
gather on the model's device.

Envelope-constrained duplex pair decoding.

The reference's duplex caller (ub-bonito/bonito/cli/duplex.py:219-297)
decodes a template/complement pair jointly: per-strand transition
posteriors (`compute_transition_probs`, crf/model.py:63-76), a simplex
decode of each strand, a Needleman-Wunsch alignment of the two simplex
calls expanded into a frame-level *envelope* (`build_envelope`,
duplex.py:138-181), then `crf_beam_search_duplex` (fast-ctc-decode, Rust,
4-base only) — an approximate beam search over the joint decode.

This module is a redesign of that algorithm for the full XNA alphabet:

* transition posteriors come from `ops.crf.compute_transition_probs`;
* the envelope builder reproduces the reference's construction
  vectorised (golden-tested against the reference's own envelope code);
* the joint decode is an **exact** banded pair Viterbi over cells
  (strand1 frames consumed, strand2 frames consumed, CRF state) in
  native C++ (`native/xna_native.cpp::pair_viterbi`) with a numpy
  oracle — strictly stronger than the reference's beam approximation
  (it maximises the true joint path score instead of pruning), and
  alphabet-size agnostic.
"""

from __future__ import annotations

import numpy as np
import torch

from xna_basecaller_tpu_torch.data import chunkops
from xna_basecaller_tpu_torch.ops import crf as crf_ops
from xna_basecaller_tpu_torch.utils import native
from xna_basecaller_tpu_torch.utils.device import on_device

NEG = -1e30


# ---------------------------------------------------------------------------
# Needleman-Wunsch columns (numpy oracle for native.nw_trace)
# ---------------------------------------------------------------------------

def nw_trace_np(a: str, b: str, match: int = 5, mismatch: int = -4,
                gap: int = 2) -> np.ndarray:
    """Global NW alignment columns [(idx_a, idx_b)] in the reference's
    cumsum-1 form (duplex.py:143-148).  Mirrors the native kernel's DP
    and tie-breaking (diag > consume-a > consume-b) exactly."""
    na, nb = len(a), len(b)
    score = np.zeros((na + 1, nb + 1), np.int32)
    tb = np.zeros((na + 1, nb + 1), np.uint8)
    score[0] = -gap * np.arange(nb + 1)
    tb[0] = 2
    tb[1:, 0] = 1
    an = np.frombuffer(a.encode(), np.uint8)
    bn = np.frombuffer(b.encode(), np.uint8)
    sub = np.where((an[:, None] == ord("N")) | (bn[None, :] == ord("N")),
                   -2, np.where(an[:, None] == bn[None, :], match,
                                mismatch)) if na and nb else None
    for i in range(1, na + 1):
        score[i, 0] = -gap * i
        diag = score[i - 1, :-1] + sub[i - 1]
        up = score[i - 1, 1:] - gap
        row = score[i]
        for j in range(1, nb + 1):
            best, mv = diag[j - 1], 0
            if up[j - 1] > best:
                best, mv = up[j - 1], 1
            left = row[j - 1] - gap
            if left > best:
                best, mv = left, 2
            row[j] = best
            tb[i, j] = mv
    moves = []
    i, j = na, nb
    while i > 0 or j > 0:
        mv = tb[i, j]
        moves.append(mv)
        if mv == 0:
            i, j = i - 1, j - 1
        elif mv == 1:
            i -= 1
        else:
            j -= 1
    moves.reverse()
    pairs = np.empty((len(moves), 2), np.int32)
    ca = cb = 0
    for k, mv in enumerate(moves):
        if mv == 0:
            ca, cb = ca + 1, cb + 1
        elif mv == 1:
            ca += 1
        else:
            cb += 1
        pairs[k] = (ca - 1, cb - 1)
    return pairs


def nw_columns(a: str, b: str) -> np.ndarray:
    got = native.nw_trace(a, b)
    return got if got is not None else nw_trace_np(a, b)


# ---------------------------------------------------------------------------
# envelope (reference build_envelope, duplex.py:138-181, vectorised)
# ---------------------------------------------------------------------------

def build_envelope(len1: int, path1: np.ndarray, len2: int,
                   path2: np.ndarray, alignment: np.ndarray,
                   padding: int = 15) -> np.ndarray:
    """Frame-level strand2 window per strand1 frame.

    ``path*`` are emission frame indices of the simplex calls;
    ``alignment`` the NW columns (idx1, idx2).  Reproduces the reference
    loop exactly: per-base min-start/max-end aggregation over aligned
    partner bases, expansion to the base's frame range, +/- padding,
    clip to [0, len2], then the two monotonicity fix-ups."""
    path1 = np.asarray(path1, np.int64)
    path2 = np.asarray(path2, np.int64)
    L1, L2 = len(path1), len(path2)
    env = np.full((len1, 2), -1, np.int64)
    if L1 and L2 and len(alignment):
        pr1 = np.stack([path1, np.append(path1[1:], len1)], 1)
        pr2 = np.stack([path2, np.append(path2[1:], len2)], 1)
        idx1 = np.clip(alignment[:, 0], 0, L1 - 1)
        idx2 = np.clip(alignment[:, 1], 0, L2 - 1)
        lo_b = np.full(L1, np.iinfo(np.int64).max)
        hi_b = np.full(L1, np.iinfo(np.int64).min)
        np.minimum.at(lo_b, idx1, pr2[idx2, 0])
        np.maximum.at(hi_b, idx1, pr2[idx2, 1])
        touched = hi_b > np.iinfo(np.int64).min
        counts = pr1[:, 1] - pr1[:, 0]
        counts = np.where(touched, np.maximum(counts, 0), 0)
        base_of = np.repeat(np.arange(L1), counts)
        offs = np.arange(counts.sum()) - np.repeat(
            np.cumsum(counts) - counts, counts)
        frames = np.repeat(pr1[:, 0], counts) + offs
        ok = (frames >= 0) & (frames < len1)
        env[frames[ok], 0] = lo_b[base_of[ok]]
        env[frames[ok], 1] = hi_b[base_of[ok]]
    env[:, 0] -= padding
    env[:, 1] += padding
    env = np.clip(env, 0, len2)
    # monotonicity fix-ups (duplex.py:170-181): empty windows reset to 0;
    # each window start may not pass the previous window's end
    env[:, 0] = np.where(env[:, 0] > env[:, 1], 0, env[:, 0])
    prev_end = np.concatenate([[0], env[:-1, 1]])
    env[:, 0] = np.minimum(env[:, 0], prev_end)
    return env


# ---------------------------------------------------------------------------
# pair Viterbi (numpy oracle for native.pair_viterbi)
# ---------------------------------------------------------------------------

def pair_viterbi_np(logt1, logi1, logt2, logi2, env, n_base: int):
    """Exact envelope-banded pair Viterbi — oracle mirroring the native
    kernel's DP, option order, and tie-breaking.  O(T1*T2*ns*nb): tests
    only."""
    logt1 = np.asarray(logt1, np.float64)
    logt2 = np.asarray(logt2, np.float64)
    T1, ns, nk = logt1.shape
    T2 = logt2.shape[0]
    nb = n_base
    nsd = ns // nb
    lo = np.zeros(T1 + 1, np.int64)
    hi = np.zeros(T1 + 1, np.int64)
    hi[0] = min(int(env[0, 1]), T2)
    lo[1:] = np.clip(env[:, 0], 0, None)
    hi[1:] = np.minimum(env[:, 1], T2)
    lo = np.minimum(lo, hi)
    hi[T1] = T2
    lo[T1] = min(lo[T1], T2)

    s_arr = np.arange(ns)
    b_of = s_arr % nb                               # emitted base per state
    o_of = (np.arange(nb)[:, None] * nsd
            + (s_arr // nb)[None, :])               # [nb, ns] old states

    dp_prev = np.full((T2 + 1, ns), NEG)
    tb = np.full((T1 + 1, T2 + 1, ns), 255, np.uint8)
    dp_prev[0] = logi1 + logi2
    for j in range(1, hi[0] + 1):
        dp_prev[j] = dp_prev[j - 1] + logt2[j - 1, :, 0]
        tb[0, j] = 1
    for i in range(1, T1 + 1):
        dp_cur = np.full((T2 + 1, ns), NEG)
        for j in range(lo[i], hi[i] + 1):
            cands = np.full((2 + nb, ns), -np.inf)
            if lo[i - 1] <= j <= hi[i - 1]:
                cands[0] = dp_prev[j] + logt1[i - 1, :, 0]
            if j >= 1 and j - 1 >= lo[i]:
                cands[1] = dp_cur[j - 1] + logt2[j - 1, :, 0]
            if j >= 1 and lo[i - 1] <= j - 1 <= hi[i - 1]:
                e1 = logt1[i - 1][o_of, 1 + b_of]   # [nb, ns]
                e2 = logt2[j - 1][o_of, 1 + b_of]
                cands[2:] = dp_prev[j - 1][o_of] + e1 + e2
            mv = np.argmax(cands, axis=0)
            dp_cur[j] = cands[mv, s_arr]
            valid = np.isfinite(cands).any(axis=0)
            tb[i, j] = np.where(valid, mv, 255)
        dp_prev = dp_cur
    s = int(np.argmax(dp_prev[T2]))
    codes, frames = [], []
    i, j = T1, T2
    while i > 0 or j > 0:
        mv = tb[i, j, s]
        if mv == 0:
            i -= 1
        elif mv == 1:
            j -= 1
        elif mv == 255:
            break
        else:
            codes.append(s % nb + 1)
            frames.append(i - 1)
            s = (mv - 2) * nsd + s // nb
            i, j = i - 1, j - 1
    return (np.array(codes[::-1], np.int32),
            np.array(frames[::-1], np.int32))


# ---------------------------------------------------------------------------
# simplex decode over transition posteriors
# ---------------------------------------------------------------------------

def simplex_from_trans(logt, logi, n_base: int):
    """Single-strand Viterbi over log transition posteriors: returns
    (codes 1..n_base [L], emission frames [L]).  The role of the
    reference's `crf_beam_search(trans, init)` simplex call
    (duplex.py:274-275): a sequence + frame anchors for envelope
    construction and the pair/simplex match check."""
    logt = np.asarray(logt, np.float64)
    T, ns, nk = logt.shape
    nb = n_base
    nsd = ns // nb
    s_arr = np.arange(ns)
    b_of = s_arr % nb
    o_of = (np.arange(nb)[:, None] * nsd + (s_arr // nb)[None, :])
    dp = np.asarray(logi, np.float64).copy()
    tbs = np.empty((T, ns), np.uint8)
    for t in range(T):
        stay = dp + logt[t, :, 0]
        emit = dp[o_of] + logt[t][o_of, 1 + b_of]       # [nb, ns]
        cands = np.concatenate([stay[None], emit], 0)   # [1+nb, ns]
        mv = np.argmax(cands, axis=0)
        dp = cands[mv, s_arr]
        tbs[t] = mv
    s = int(np.argmax(dp))
    codes, frames = [], []
    for t in range(T - 1, -1, -1):
        mv = tbs[t, s]
        if mv > 0:
            codes.append(s % nb + 1)
            frames.append(t)
            s = (mv - 1) * nsd + s // nb
    return (np.array(codes[::-1], np.int32),
            np.array(frames[::-1], np.int32))


# ---------------------------------------------------------------------------
# full pair decode
# ---------------------------------------------------------------------------

def read_transition_probs(model, signal, chunksize: int = 3600,
                          overlap: int = 500, reverse: bool = False):
    """Full-read log transition posteriors + log initial-state posteriors.

    The duplex score path (reference cli/duplex.py:219-255), on the
    model's device: chunk the signal, forward through the encoder in f32
    (K1's f32 route on the card), reverse-complement the complement
    strand's scores into template orientation, compute per-chunk
    transition posteriors (the betas from K2a), and stitch them
    frame-accurately across chunk overlaps (stitch semantics of
    util.py:169-188; for the reverse strand the chunk order flips, so the
    read's initial state is the last chunk's beta_0).  The stitch gathers
    the kept frames on the device, so that only they are fetched; the log
    is taken on the host, as JAX takes it."""
    nb = model.seqdist.n_base
    sl = model.seqdist.state_len
    dev = next(model.parameters()).device
    chunks = chunkops.chunk(np.asarray(signal, np.float32),
                            chunksize, overlap)
    with torch.inference_mode(), on_device(dev):
        scores = model(torch.from_numpy(np.ascontiguousarray(chunks)).to(dev),
                       compute_dtype=torch.float32)
        if reverse:
            scores = model.seqdist.reverse_complement(scores)
        trans, init = crf_ops.compute_transition_probs(scores, nb, sl)
        N, T = trans.shape[1], trans.shape[0]
        # the frames the stitch keeps, as flat indices into [N * T']
        keep = chunkops.stitch(np.arange(N * T).reshape(N, T), chunksize,
                               overlap, len(signal), model.stride,
                               reverse=reverse)
        flat = trans.transpose(0, 1).reshape(N * T, *trans.shape[2:])
        stitched = flat[torch.from_numpy(np.asarray(keep)).to(dev)]
        stitched = stitched.cpu().numpy()
        init0 = init[-1 if reverse else 0].cpu().numpy()
    return (np.log(stitched + 1e-30).astype(np.float32),
            np.log(init0 + 1e-30).astype(np.float32))


def decode_pair(logt1, logi1, logt2, logi2, alphabet: str,
                padding: int = 40, min_match: float = 0.80,
                min_len: int = 10, min_coverage: float = 0.5):
    """Joint decode of a template/complement pair already expressed as
    log transition posteriors in the SAME orientation (the complement's
    scores reverse-complemented before `compute_transition_probs`, as at
    duplex.py:219-228).

    Returns (sequence, qstring) or None when the pair fails the simplex
    match gate (duplex.py:283-287) or the DP is infeasible — the caller
    falls back to the quality-arithmetic consensus merge.
    """
    from xna_basecaller_tpu_torch.eval.accuracy import accuracy

    n_base = len(alphabet) - 1
    c1, f1 = simplex_from_trans(logt1, logi1, n_base)
    c2, f2 = simplex_from_trans(logt2, logi2, n_base)
    if len(c1) < min_len or len(c2) < min_len:
        return None
    seq1 = "".join(alphabet[c] for c in c1)
    seq2 = "".join(alphabet[c] for c in c2)
    if accuracy(seq1, seq2, min_coverage=min_coverage) < min_match * 100:
        return None
    env = build_envelope(logt1.shape[0], f1, logt2.shape[0], f2,
                         nw_columns(seq1, seq2), padding=padding)
    got = native.pair_viterbi(logt1, logi1, logt2, logi2, env, n_base)
    if got is None:
        return None
    codes, frames = got
    if not len(codes):
        return None
    seq = "".join(alphabet[c] for c in codes)
    # per-base quality from the template strand's posterior of the
    # decoded base at its emission frame (best over old states)
    p1 = np.exp(np.asarray(logt1)[frames, :, 1 + (codes - 1)].max(axis=1))
    q = np.clip((-10 * np.log10(np.clip(1 - p1, 1e-6, 1.0))).astype(int),
                0, 50)
    qstring = "".join(chr(33 + int(x)) for x in q)
    return seq, qstring
