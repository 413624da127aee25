"""Plain CTC ops of the legacy QuartzNet model family.

Port of ``xna_basecaller_tpu/ops/ctc.py``.  Blank is class 0 everywhere
(the alphabet "NACGT..." with N the blank label).

* ``ctc_loss_logz``: the log-likelihood of each target under the CTC
  lattice.  The JAX package runs the interleaved-blank forward recursion
  as an XLA ``lax.scan``, not as a Pallas kernel; here it is
  ``torch.nn.functional.ctc_loss(reduction="none")``, on whichever device
  the log-probs are.  Its backward is torch's: the gradient it hands back
  for the log-probs is ``exp(log_probs) - posterior``, which equals the
  exact gradient once it has gone back through the ``log_softmax`` that
  makes the log-probs (every frame's posteriors sum to 1), as in the
  QuartzNet model; it is not the gradient with respect to log-probs that
  are not a log-softmax.  A target that cannot be aligned in T frames
  gives +inf (JAX's recursion gives a huge finite value).
* ``greedy_paths``: the per-frame argmax (without transition scores the
  CTC Viterbi path is the per-frame argmax), on the log-probs' device.
* ``collapse_path`` (sequence, q-string and moves of a best path) and
  ``beam_search`` (prefix beam search over one read's posteriors: the
  native C++ kernel, with the pure-Python ``_beam_search_py`` as its
  fallback and definition) run on the host; they are copies of JAX's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def ctc_loss_logz(log_probs: torch.Tensor, targets: torch.Tensor,
                  target_lengths: torch.Tensor) -> torch.Tensor:
    """log_probs [T, N, C] log-softmax scores (class 0 = blank), targets
    [N, L] labels in 1..C-1 zero-padded, target_lengths [N] (<= L) ->
    logZ [N] (the loss is ``-logZ``), in f32."""
    T, N, _ = log_probs.shape
    input_lengths = torch.full((N,), T, dtype=torch.long,
                               device=log_probs.device)
    return -F.ctc_loss(log_probs.float(), targets.long(), input_lengths,
                       target_lengths.long(), blank=0, reduction="none")


def ctc_loss(log_probs, targets, target_lengths, reduction: str = "mean"):
    """torch.nn.functional.ctc_loss semantics (reference ctc/model.py:52):
    per-sample -logZ, 'mean' divides each by its target length then
    averages over the batch."""
    nll = -ctc_loss_logz(log_probs, targets, target_lengths)
    if reduction == "none":
        return nll
    per = nll / target_lengths.to(nll.dtype).clamp(min=1.0)
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return nll.sum()
    raise ValueError(f"unknown reduction {reduction!r}")


def smoothing_weights(C: int, like: torch.Tensor) -> torch.Tensor:
    """The label-smoothing weights: 0.4 on blank, 0.1/(C-1) on the rest."""
    w = torch.full((C,), 0.1 / (C - 1), dtype=like.dtype, device=like.device)
    w[0] = 0.4
    return w


def ctc_label_smoothing_loss(log_probs, targets, target_lengths,
                             weights=None):
    """CTC + label-smoothing loss (reference ctc/model.py:48-54): weight
    0.4 on blank, 0.1/(C-1) spread over the rest."""
    if weights is None:
        weights = smoothing_weights(log_probs.shape[2], log_probs)
    loss = ctc_loss(log_probs, targets, target_lengths)
    smooth = -(log_probs * weights).mean()
    return {"loss": loss + smooth, "ctc_loss": loss,
            "label_smooth_loss": smooth}


def greedy_paths(log_probs: torch.Tensor):
    """[T, N, C] log-probs -> (paths [N, T] int32, probs [N, T] f32): the
    per-frame argmax and the winning class's posterior."""
    top, path = log_probs.max(dim=2)
    return path.T.to(torch.int32), torch.exp(top).T.float()


def collapse_path(path, probs=None, alphabet: str = "NACGT",
                  qscale: float = 1.0, qbias: float = 0.0):
    """Collapse a best path: drop blanks + merge repeats.

    Returns (sequence, qstring, moves): moves[t] = 1 where a new base is
    emitted at frame t (the reference's ``path`` output from
    viterbi_search, ctc/basecall.py:48-63).  qstring per emitted base uses
    the mean posterior over the base's frame run, phred-encoded with the
    model's qscale/qbias calibration.
    """
    path = np.asarray(path)
    prev = np.concatenate([[0], path[:-1]])
    emit = (path != 0) & (path != prev)                   # new-base frames
    labels = path[emit]
    seq = "".join(alphabet[i] for i in labels)
    if probs is None:
        return seq, "*", emit
    probs = np.asarray(probs)
    # mean prob over each run: frames belong to the most recent emission
    run_id = np.cumsum(emit) - 1                          # -1 before first
    valid = (run_id >= 0) & (path != 0)
    n_runs = int(emit.sum())
    if n_runs == 0:
        return "", "", emit
    sums = np.bincount(run_id[valid], weights=probs[valid],
                       minlength=n_runs)
    counts = np.bincount(run_id[valid], minlength=n_runs)
    mean_p = sums / np.maximum(counts, 1)
    err = np.clip(1.0 - mean_p, 1e-7, 1.0)
    q = np.clip(-10.0 * np.log10(err) * qscale + qbias, 1.0, 50.0)
    qstring = "".join(chr(int(round(x)) + 33) for x in q)
    return seq, qstring, emit


def beam_search(probs, alphabet: str = "NACGT", beamsize: int = 5,
                threshold: float = 1e-3):
    """Prefix beam search over one read's posteriors [T, C] (class 0 =
    blank).  Returns (sequence, path) where path[i] is the frame at which
    base i was first emitted — the fast-ctc-decode beam_search contract
    (reference ctc/model.py:44).  The native C++ kernel where the library
    builds; ``_beam_search_py`` defines the semantics and is the
    fallback."""
    from xna_basecaller_tpu_torch.utils import native
    probs = np.ascontiguousarray(probs, np.float32)
    if native.available():
        out = native.ctc_beam_search(probs, alphabet, beamsize, threshold)
        if out is not None:
            return out
    return _beam_search_py(probs, alphabet, beamsize, threshold)


def _beam_search_py(probs, alphabet, beamsize, threshold):
    T, C = probs.shape
    # beams: prefix tuple -> (p_blank, p_non_blank); emission frame of each
    # prefix's last base is memoised at prefix creation (deterministic and
    # shared with the native kernel's trie representation)
    beams = {(): (1.0, 0.0)}
    first_frame: dict = {}
    for t in range(T):
        frame = probs[t]
        nxt: dict = {}

        def acc(prefix, pb, pnb):
            opb, opnb = nxt.get(prefix, (0.0, 0.0))
            nxt[prefix] = (opb + pb, opnb + pnb)

        for prefix, (pb, pnb) in beams.items():
            total = pb + pnb
            # blank extends both: prefix unchanged
            if frame[0] > threshold:
                acc(prefix, total * frame[0], 0.0)
            for c in range(1, C):
                p = frame[c]
                if p <= threshold:
                    continue
                if prefix and prefix[-1] == c:
                    # repeat: merges into the same prefix (non-blank path)
                    acc(prefix, 0.0, pnb * p)
                    # emit a NEW same base only after a blank
                    ext = prefix + (c,)
                    first_frame.setdefault(ext, t)
                    acc(ext, 0.0, pb * p)
                else:
                    ext = prefix + (c,)
                    first_frame.setdefault(ext, t)
                    acc(ext, 0.0, total * p)
        beams = dict(sorted(nxt.items(), key=lambda kv: -(kv[1][0] + kv[1][1])
                            )[:beamsize])
        if not beams:
            beams = {(): (1.0, 0.0)}
    best, _ = max(beams.items(), key=lambda kv: kv[1][0] + kv[1][1])
    seq = "".join(alphabet[c] for c in best)
    frames = [first_frame[best[:i + 1]] for i in range(len(best))]
    return seq, np.asarray(frames, np.int64)


def log_softmax_scores(scores: torch.Tensor, reverse: bool = False):
    """Raw decoder output [T, ..., C] -> log-probs; optionally
    time-reversed for R-strand chunks."""
    lp = torch.log_softmax(scores, dim=-1)
    if reverse:
        lp = lp.flip(0)
    return lp
