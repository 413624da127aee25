"""What decides ``correct``: the plain reference against the program's
outputs.

Basecalling.  For each sampled read the reference cuts the signal into
chunks itself and computes each chunk's f32 edge weights (the log edge
posteriors that the Viterbi decode maximises).  On every frame that the
stitch kept, the gap of the program's label is the best path's value less
the best value of a path that takes that label there (Viterbi's
max-marginals): 0 where the program's label lies on a best path of the
reference.  A label that no path can take, or a call of the wrong length
or with a letter outside the model's, reads as an infinite gap.  A cell
compares the share of kept frames whose gap exceeds a number of nats.

Training.  The reference follows steps of the program on the same
batches: each step's loss, the gradient of its first step after the
global-norm clip (as AdamW receives it) and the change of the parameters
over the steps.  The first steps start from the seeded weights and a
fresh AdamW; a step of the timed window starts from the program's own
parameters and AdamW state, as the program held them before that step.
Norms are compared leaf by leaf: the gap between the two norms of a leaf
over the larger of the reference's norm of that leaf and the median
leaf's; leaves whose first gradient in the reference is under a
thousandth of the median leaf's move by round-off alone and are left out.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import crf
from portbench.reference.chunks import chunk, kept_frames
from portbench.reference.model import f32_mm, forward, pin_f32
from portbench.weights import model_dims


def stitched_labels(moves: np.ndarray, sequence: str, alphabet: str):
    """The per-frame labels of a stitched call, or None where the call is
    malformed (its bases do not fill its moves, or a base is not a
    letter of the model)."""
    moves = np.asarray(moves, bool)
    if int(moves.sum()) != len(sequence):
        return None
    lut = np.full(256, -1, np.int64)
    for i, c in enumerate(alphabet[1:], start=1):
        lut[ord(c)] = i
    codes = lut[np.frombuffer(sequence.encode("ascii", "replace"), np.uint8)]
    if (codes < 0).any():
        return None
    labels = np.zeros(len(moves), np.int64)
    labels[moves] = codes
    return labels


def frame_gaps(weights: dict, model: dict, calls, chunksize: int,
               overlap: int, rows: int, device) -> np.ndarray:
    """The gap of the label of ``calls`` [(signal, moves, sequence)] on
    each kept frame, in nats; a malformed call reads as infinite gaps.
    The reference runs ``rows`` chunks at a time."""
    pin_f32()
    dims = model_dims(model)
    nb, sl = dims["n_base"], dims["state_len"]
    T = chunksize // dims["stride"]
    sigs, labs = [], []
    bad_frames = 0
    for signal, moves, sequence in calls:
        chunks = chunk(np.asarray(signal, np.float32), chunksize, overlap)
        kept = kept_frames(len(chunks), len(signal), chunksize, overlap,
                           dims["stride"])
        labels = stitched_labels(moves, sequence, dims["alphabet"])
        if labels is None or len(labels) != sum(b - a for a, b in kept):
            bad_frames += sum(b - a for a, b in kept)
            continue
        off = 0
        for c, (a, b) in zip(chunks, kept):
            lab = np.full(T, -1, np.int64)
            lab[a:b] = labels[off:off + b - a]
            off += b - a
            sigs.append(c)
            labs.append(lab)
    out = [np.full(bad_frames, np.inf)]
    with torch.no_grad():
        for lo in range(0, len(sigs), rows):
            sig = torch.from_numpy(np.stack(sigs[lo:lo + rows])).to(device)
            lab = torch.from_numpy(np.stack(labs[lo:lo + rows])).to(device).T
            w = crf.viterbi_weights(forward(weights, model, sig), nb, sl)
            mm = crf.max_marginals(w, nb)                  # [T, N, nb + 1]
            del w
            kept = lab >= 0
            got = mm.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
            out.append((mm.amax(-1) - got)[kept].double().cpu().numpy())
    return np.concatenate(out)


def train_reference(weights: dict, model: dict, batches, lr: float,
                    weight_decay: float, clip: float, device,
                    mm=f32_mm, state: dict | None = None) -> dict:
    """The reference's steps over ``batches`` [(chunks, targets, lengths)
    host arrays] from ``weights``: {"losses": [...], "grad1": {leaf: the
    first step's clipped gradient}, "change": {leaf: norm of the change
    over the steps}}.  AdamW as PyTorch and optax define it (b1 0.9, b2
    0.999, eps 1e-8 outside the root, decoupled decay), the clip scaling
    by clip / ||g|| where ||g|| >= clip.  ``state`` {"m": {leaf: first
    moment}, "s": {leaf: second moment}, "steps": steps taken} starts
    AdamW where a run left it; without it AdamW starts afresh."""
    pin_f32()
    dims = model_dims(model)
    nb, sl = dims["n_base"], dims["state_len"]
    p0 = {k: v.detach().float().clone() for k, v in weights.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    if state is None:
        state = {"m": {}, "s": {}, "steps": 0}
    m = {k: state["m"][k].float().clone() if k in state["m"]
         else torch.zeros_like(v) for k, v in p0.items()}
    s = {k: state["s"][k].float().clone() if k in state["s"]
         else torch.zeros_like(v) for k, v in p0.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad1 = [], {}
    for step, (c, t, l) in enumerate(batches, start=int(state["steps"]) + 1):
        c = torch.as_tensor(np.asarray(c, np.float32), device=device)
        t = torch.as_tensor(np.asarray(t, np.int64), device=device)
        l = torch.as_tensor(np.asarray(l, np.int64), device=device)
        valid = (l > 0).float()
        scores = forward(params, model, c, mm=mm)
        per = crf.ctc_loss(scores, t, l.clamp(min=sl + 1), nb, sl)
        loss = (per * valid).sum() / valid.sum().clamp(min=1.0)
        grads = torch.autograd.grad(loss, list(params.values()))
        del scores, per
        norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
        scale = clip / norm if norm >= clip else 1.0
        grads = [g * scale for g in grads]
        if not grad1:
            grad1 = {k: g.detach().clone() for k, g in zip(params, grads)}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                p.mul_(1 - lr * weight_decay)
                m[k].lerp_(g, 1 - b1)
                s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (s[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
        del grads
    change = {k: float((params[k].detach() - p0[k]).norm()) for k in params}
    return {"losses": losses, "grad1": grad1, "change": change}


def _relative(gap: dict, ref: dict, kept: list) -> dict:
    """Each kept leaf's ``gap`` over the larger of the reference's value
    of that leaf and of the median kept leaf."""
    med = float(np.median([ref[k] for k in kept]))
    return {k: gap[k] / max(ref[k], med) for k in kept}


def _worst(values: dict) -> float:
    """The largest value; infinite where any is not a number."""
    v = list(values.values())
    return max(v) if all(math.isfinite(x) for x in v) else math.inf


def train_gaps(prog: dict, ref: dict) -> dict:
    """The program's steps against the reference's (each a dict as
    ``train_reference`` returns): "loss1", the first step's loss gap over
    the reference's loss; "grad_diff", the worst leaf's norm of the
    difference of the two first-step gradients; "change", the worst
    leaf's gap of the change's norm (both over the larger of that leaf's
    and the median leaf's reference norm); "left_out", the leaves left
    out."""
    g_ref = {k: float(v.norm()) for k, v in ref["grad1"].items()}
    g_med = float(np.median(list(g_ref.values())))
    kept = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    diff = {k: float((prog["grad1"][k].float() - ref["grad1"][k].to(
        prog["grad1"][k].device).float()).norm()) for k in kept}
    grad_diff = _relative(diff, g_ref, kept)
    change = _relative({k: abs(prog["change"][k] - ref["change"][k])
                        for k in kept}, ref["change"], kept)
    a, b = prog["losses"][0], ref["losses"][0]
    return {"loss1": abs(a - b) / abs(b) if math.isfinite(a) else math.inf,
            "grad_diff": _worst(grad_diff), "change": _worst(change),
            "left_out": sorted(set(g_ref) - set(kept))}
