"""k-mer CTC-CRF in plain PyTorch: the decoders and the training loss.

Port of ``xna_basecaller_tpu/ops/crf.py``: the forward and backward scans
in the Log and the Max semiring, the Viterbi decode over the log edge
posteriors (with the posterior of each chosen transition for q-scores,
``decode_paths_with_qual``), the path-collapsing beam decode
(``decode_beam``), the Max-semiring traceback (``viterbi_path``,
``_viterbi_onehot``), ``compute_transition_probs``,
``ctc_viterbi_alignments``, ``reverse_complement``, and the loss side of
the CRF: ``logz`` (a ``torch.autograd.Function`` whose backward is the
explicit edge posteriors, as ``logz_fwd``'s custom VJP, or the one-hot
Viterbi path in the Max semiring), ``posteriors``, ``normalise``,
``prepare_ctc_scores``, the stay/move lattice logZ with its explicit
backward, and ``ctc_loss``.  The two Log autograd Functions run the CUDA
kernels of ``ops/crf_cuda.py`` for tensors on the card, as the JAX
package's default (Pallas) loss does, and their plain versions here for
tensors on the CPU: ``forward_scores`` (K4), ``backward_scores`` (K5a),
``edge_posteriors`` (K5b), ``lattice_forward`` (K6a) and
``lattice_backward`` (K6b).  The kernels are Log only, as the JAX
package's Pallas path is (``_pallas_log_path``): the Max semiring runs
these plain scans on any device.

Scores are [T, N, C] with C = n_state * (n_base + 1); reshaped to
[T, N, n_state, n_base + 1], column 0 is the stay transition and column
1 + i the move into the state that dropped base i.

The decode is split as the CUDA kernels of ``ops/crf_cuda.py`` split it,
and these functions are their plain versions: ``backward_scores`` (K2a;
logZ = logsumexp(beta_0), as ``crf_pallas.py:341``), ``forward_viterbi``
(K2b) and ``viterbi_traceback`` (K2c); with ``qual`` and ``edge_sel``
they are the plain versions of the q-score variants of K2b and K2c.  Each
step keeps the op order of the JAX ``decode_paths`` (``crf.py:331-341``
there).  ``beam_search`` is the plain version of the beam kernel
(``csrc/crf_beam.cu``), which runs on the alphas of K4 and the betas of
K2a.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from xna_basecaller_tpu_torch.core.alphabet import BASES, COMPLEMENT

LOG = "log"
MAX = "max"

_NEG_INF = -1e38   # finite "zero" of the log semiring; avoids inf - inf

# Rolling-hash multipliers of the beam's sequence identity (two
# independent 32-bit streams; a collision needs both to collide).
_HASH_P1 = 1000003
_HASH_P2 = 2654435761


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log(sum(exp(x))) over ``dim`` as max + log(sum(exp(x - max)))."""
    m = x.amax(dim, keepdim=True)
    return (m + torch.log(torch.exp(x - m).sum(dim, keepdim=True))
            ).squeeze(dim)


def semiring_sum(x: torch.Tensor, dim: int, semiring: str = LOG):
    """The semiring's sum over ``dim``: logsumexp (Log) or max (Max)."""
    if semiring == LOG:
        return _lse(x, dim)
    if semiring == MAX:
        return x.amax(dim)
    raise ValueError(semiring)


def _expand_pred(alpha: torch.Tensor, n_base: int, n_state: int):
    """alpha [N, n_state] -> pred [N, n_state, n_base] with
    pred[n, j, i] = alpha[n, i * (n_state // n_base) + j // n_base]."""
    N = alpha.shape[0]
    nsd = n_state // n_base
    a = alpha.reshape(N, n_base, nsd, 1).expand(N, n_base, nsd, n_base)
    return a.reshape(N, n_base, n_state).transpose(1, 2)


def _bwd_step(beta: torch.Tensor, ms_t: torch.Tensor, n_base: int,
              n_state: int, semiring: str = LOG) -> torch.Tensor:
    """beta_{t+1} [N, ns] -> beta_t: the stay column plus, for state
    k = i*nsd + m, S.sum_b(Ms[t, m*n_base + b, 1 + i] + beta[m*n_base + b])
    (S.sum: lse in the Log semiring, max in the Max)."""
    N = beta.shape[0]
    nsd = n_state // n_base
    mr = ms_t[..., 1:].reshape(N, nsd, n_base, n_base)   # [n, m, b, i]
    br = beta.reshape(N, nsd, n_base)
    summed = semiring_sum(mr + br[..., None], 2, semiring)   # [n, m, i]
    move = summed.transpose(1, 2).reshape(N, n_state)    # k = i*nsd + m
    stay = ms_t[..., 0] + beta
    return semiring_sum(torch.stack([stay, move], -1), -1, semiring)


def _split(scores: torch.Tensor, n_base: int, state_len: int):
    T, N, _ = scores.shape
    ns = n_base ** state_len
    return scores.reshape(T, N, ns, n_base + 1), ns


def forward_scores(scores: torch.Tensor, n_base: int, state_len: int,
                   semiring: str = LOG):
    """All forward partials alpha_t: [T, N, C] -> [T+1, N, n_state], with
    alpha_0 = 0.  Plain version of K4 (Log)."""
    Ms, ns = _split(scores, n_base, state_len)
    alpha = scores.new_zeros(scores.shape[1], ns)
    out = [alpha]
    for ms_t in Ms:
        stay = alpha + ms_t[..., 0]
        move = _expand_pred(alpha, n_base, ns) + ms_t[..., 1:]
        alpha = semiring_sum(torch.cat([stay[..., None], move], -1), -1,
                             semiring)
        out.append(alpha)
    return torch.stack(out)


def backward_scores(scores: torch.Tensor, n_base: int, state_len: int,
                    semiring: str = LOG):
    """All backward partials beta_t: [T, N, C] -> [T+1, N, n_state], with
    beta_T = 0.  Plain version of K2a, which is K5a too (Log)."""
    Ms, ns = _split(scores, n_base, state_len)
    T = scores.shape[0]
    betas = scores.new_empty(T + 1, scores.shape[1], ns)
    betas[T] = 0.0
    for t in range(T - 1, -1, -1):
        betas[t] = _bwd_step(betas[t + 1], Ms[t], n_base, ns, semiring)
    return betas


def logz_from_betas(betas: torch.Tensor) -> torch.Tensor:
    """logZ [N] = logsumexp(beta_0): alpha_0 == 0, so this is the same
    partition function the forward scan ends with."""
    return _lse(betas[0], -1)


def forward_viterbi(scores: torch.Tensor, betas: torch.Tensor,
                    logz: torch.Tensor, n_base: int, state_len: int,
                    qual: bool = False):
    """Plain version of K2b: the forward scan fused with Viterbi over
    log(exp(alpha[pred] + score + beta_{t+1} - logZ) + 1e-8).

    Returns (backpointers [T, N, n_state] uint8, v_final [N, n_state]);
    a backpointer is the chosen column k (0 = stay), the first maximum.
    With ``qual`` (K2b's q-score variant) also edge_sel [T, N, n_state]
    f32: the raw edge alpha[pred] + score + beta_{t+1} - logZ of the
    chosen column, whose exp() is the transition's posterior."""
    Ms, ns = _split(scores, n_base, state_len)
    T, N = scores.shape[:2]
    alpha = scores.new_zeros(N, ns)
    v = scores.new_zeros(N, ns)
    bp = torch.empty(T, N, ns, dtype=torch.uint8, device=scores.device)
    edge_sel = scores.new_empty(T, N, ns) if qual else None
    for t in range(T):
        ms_t = Ms[t]
        pred_a = _expand_pred(alpha, n_base, ns)
        edge = torch.cat([alpha[..., None], pred_a], -1) + ms_t \
            + betas[t + 1][..., None] - logz[:, None, None]
        s2 = torch.log(torch.exp(edge) + 1e-8)
        stay = v + s2[..., 0]
        move = _expand_pred(v, n_base, ns) + s2[..., 1:]
        full = torch.cat([stay[..., None], move], -1)
        k = full.argmax(-1)
        bp[t] = k.to(torch.uint8)
        if qual:
            edge_sel[t] = edge.gather(-1, k[..., None])[..., 0]
        v = full.amax(-1)
        alpha = _lse(torch.cat([(alpha + ms_t[..., 0])[..., None],
                                pred_a + ms_t[..., 1:]], -1), -1)
    return (bp, v, edge_sel) if qual else (bp, v)


def viterbi_traceback(bp: torch.Tensor, v_final: torch.Tensor,
                      n_base: int, state_len: int,
                      edge_sel: torch.Tensor | None = None):
    """Plain version of K2c: labels [N, T] int8 from argmax(v_final) back
    over the backpointers; j <- (k-1)*nsd + j // n_base on a move.  With
    ``edge_sel`` (K2c's q-score variant) returns (labels, probs [N, T]
    f32), probs[n, t] = exp(edge_sel[t, n, j_t]) at the state j_t the
    walk visits at t."""
    T, N, ns = bp.shape
    nsd = ns // n_base
    j = v_final.argmax(-1)
    rows = torch.arange(N, device=bp.device)
    labels = torch.empty(N, T, dtype=torch.int8, device=bp.device)
    probs = None if edge_sel is None else v_final.new_empty(N, T)
    for t in range(T - 1, -1, -1):
        k = bp[t, rows, j].long()
        labels[:, t] = k.to(torch.int8)
        if probs is not None:
            probs[:, t] = torch.exp(edge_sel[t, rows, j])
        j = torch.where(k == 0, j, (k - 1) * nsd + j // n_base)
    return labels if probs is None else (labels, probs)


def decode_paths(scores: torch.Tensor, n_base: int, state_len: int):
    """Full decode chain in plain PyTorch: scores -> labels [N, T] int8
    (0 = stay, k = alphabet[k]), in f32."""
    scores = scores.float()
    betas = backward_scores(scores, n_base, state_len)
    bp, v_final = forward_viterbi(scores, betas, logz_from_betas(betas),
                                  n_base, state_len)
    return viterbi_traceback(bp, v_final, n_base, state_len)


def decode_paths_with_qual(scores: torch.Tensor, n_base: int,
                           state_len: int):
    """The decode chain with the posterior of each chosen transition:
    scores -> (labels [N, T] int8, probs [N, T] f32), in f32 (JAX's
    ``decode_paths_with_qual``, ``crf.py:806-857``).  logZ is taken from
    the alphas, as JAX takes it; the decode chain on the card takes it
    from the betas of K2a (``crf_cuda.decode_paths_with_qual_cuda``), the
    same partition function summed the other way."""
    scores = scores.float()
    betas = backward_scores(scores, n_base, state_len)
    logz = logz_from_alphas(forward_scores(scores, n_base, state_len))
    bp, v_final, edge_sel = forward_viterbi(scores, betas, logz, n_base,
                                            state_len, qual=True)
    return viterbi_traceback(bp, v_final, n_base, state_len, edge_sel)


def _viterbi_traceback(scores: torch.Tensor, n_base: int, state_len: int):
    """Explicit Max-semiring traceback on the raw scores: (labels [T, N]
    in 0..n_base, states [T, N]) int32, the column k and new state j of
    the transition taken at each frame on the best path (JAX's
    ``_viterbi_traceback``; first maxima, as ``jnp.argmax``)."""
    Ms, ns = _split(scores, n_base, state_len)
    T, N = scores.shape[:2]
    nsd = ns // n_base
    alpha = scores.new_zeros(N, ns)
    ks = torch.empty(T, N, ns, dtype=torch.long, device=scores.device)
    for t in range(T):
        stay = alpha + Ms[t][..., 0]
        move = _expand_pred(alpha, n_base, ns) + Ms[t][..., 1:]
        full = torch.cat([stay[..., None], move], -1)
        ks[t] = full.argmax(-1)
        alpha = full.amax(-1)
    j = alpha.argmax(-1)
    rows = torch.arange(N, device=scores.device)
    labels = torch.empty(T, N, dtype=torch.int32, device=scores.device)
    states = torch.empty_like(labels)
    for t in range(T - 1, -1, -1):
        k = ks[t, rows, j]
        labels[t], states[t] = k, j
        j = torch.where(k == 0, j, (k - 1) * nsd + j // n_base)
    return labels, states


def _viterbi_onehot(scores: torch.Tensor, n_base: int, state_len: int):
    """One-hot [T, N, C] of the best path's transition at each frame: the
    gradient of the Max-semiring logZ."""
    labels, states = _viterbi_traceback(scores, n_base, state_len)
    flat = states.long() * (n_base + 1) + labels.long()
    return torch.nn.functional.one_hot(flat, scores.shape[2]).to(
        scores.dtype)


def viterbi_path(scores: torch.Tensor, n_base: int, state_len: int):
    """Most-likely per-frame labels of the Max semiring on the raw scores:
    [T, N, C] -> [T, N] int32 in 0..n_base (reference crf/model.py:92-95;
    label 0 is stay)."""
    return _viterbi_traceback(scores, n_base, state_len)[0]


def compute_transition_probs(scores: torch.Tensor, n_base: int,
                             state_len: int):
    """Per-frame transition posteriors and initial-state posteriors
    (reference CTC_CRF.compute_transition_probs, crf/model.py:63-76):
    scores plus betas, laid out from (new state, dropped base) to (old
    state, emitted base), softmax over the n_base + 1 choices {stay, emit
    b}.  Returns (trans [T, N, n_state, n_base + 1], init [N, n_state]).
    The betas come from K2a on the card."""
    from xna_basecaller_tpu_torch.ops import crf_cuda
    scores = scores.float()
    T, N, _ = scores.shape
    ns = n_base ** state_len
    betas = crf_cuda.backward_scan(scores.contiguous(), n_base, state_len)
    lt = scores.reshape(T, N, ns, n_base + 1) + betas[1:, :, :, None]
    # (new state s, dropped d) -> (old state d*ns/nb + s//nb, emitted s%nb)
    moves = lt[..., 1:].transpose(3, 2).reshape(T, N, ns, n_base)
    lt = torch.cat([lt[..., :1], moves], -1)
    return torch.softmax(lt, -1), torch.softmax(betas[0], -1)


def logz_from_alphas(alphas: torch.Tensor) -> torch.Tensor:
    """logZ [N] = logsumexp(alpha_T), the end of the forward scan."""
    return _lse(alphas[-1], -1)


def edge_posteriors(scores: torch.Tensor, alphas: torch.Tensor,
                    betas: torch.Tensor, logz: torch.Tensor,
                    ct: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K5b: the edge marginals exp(alpha_t[pred(j, k)] +
    Ms[t, j, k] + beta_{t+1}[j] - logZ) [T, N, C] (``crf.py:133-149``),
    times the cotangent ``ct`` [N] when given.  ``alphas`` and ``betas``
    are the [T+1, N, n_state] partials, ``logz`` [N]."""
    T, N, C = scores.shape
    ns = alphas.shape[-1]
    n_base = C // ns - 1
    Ms = scores.reshape(T, N, ns, n_base + 1)
    a = alphas[:-1]
    pred = _expand_pred(a.reshape(T * N, ns), n_base, ns).reshape(
        T, N, ns, n_base)
    edge = torch.cat([a[..., None], pred], -1) + Ms \
        + betas[1:][..., None] - logz[None, :, None, None]
    post = torch.exp(edge)
    if ct is not None:
        post = post * ct[None, :, None, None]
    return post.reshape(T, N, C)


def posteriors(scores: torch.Tensor, n_base: int, state_len: int,
               semiring: str = LOG,
               alphas: torch.Tensor | None = None) -> torch.Tensor:
    """Posterior transition probabilities [T, N, C], d logZ / d scores: the
    edge marginals in the Log semiring (``alphas`` are the forward
    partials when the caller has them), the one-hot Viterbi path in the
    Max."""
    if semiring == MAX:
        return _viterbi_onehot(scores, n_base, state_len)
    if semiring != LOG:
        raise ValueError(semiring)
    if alphas is None:
        alphas = forward_scores(scores, n_base, state_len)
    betas = backward_scores(scores, n_base, state_len)
    return edge_posteriors(scores, alphas, betas, logz_from_alphas(alphas))


class _LogZ(torch.autograd.Function):
    """logZ [N] of the CRF by the forward scan (K4); the backward is the
    edge posteriors times the cotangent (K5a's backward scan, then K5b), as
    ``logz_fwd``'s custom VJP, whose backward recomputes the alphas that
    this one keeps.  The kernels run for CUDA tensors, the plain versions
    for CPU ones."""

    @staticmethod
    def forward(ctx, scores, n_base: int, state_len: int):
        from xna_basecaller_tpu_torch.ops import crf_cuda
        scores = scores.contiguous()
        alphas, lz = crf_cuda.forward_scan(scores, n_base, state_len)
        ctx.save_for_backward(scores, alphas, lz)
        ctx.shape = (n_base, state_len)
        return lz

    @staticmethod
    def backward(ctx, ct):
        from xna_basecaller_tpu_torch.ops import crf_cuda
        scores, alphas, lz = ctx.saved_tensors
        betas = crf_cuda.backward_scan(scores, *ctx.shape)
        return crf_cuda.edge_posteriors(scores, alphas, betas, lz, ct), \
            None, None


class _MaxLogZ(torch.autograd.Function):
    """The Max-semiring logZ [N] (the best path's score) by the plain
    forward scan, on any device (the kernels are Log only, as the JAX
    package's Pallas path is); its backward is the one-hot Viterbi path
    times the cotangent, as ``logz_fwd``'s custom VJP."""

    @staticmethod
    def forward(ctx, scores, n_base: int, state_len: int):
        ctx.save_for_backward(scores)
        ctx.shape = (n_base, state_len)
        return forward_scores(scores, n_base, state_len, MAX)[-1].amax(-1)

    @staticmethod
    def backward(ctx, ct):
        (scores,) = ctx.saved_tensors
        onehot = _viterbi_onehot(scores, *ctx.shape)
        return onehot * ct[None, :, None].to(onehot.dtype), None, None


def logz(scores: torch.Tensor, n_base: int, state_len: int,
         semiring: str = LOG) -> torch.Tensor:
    """Partition function of the CRF, [T, N, C] -> [N] (alpha_0 = beta_T =
    0 for every state), differentiable; in the Max semiring, the best
    path's score."""
    if semiring == MAX:
        return _MaxLogZ.apply(scores, n_base, state_len)
    if semiring != LOG:
        raise ValueError(semiring)
    return _LogZ.apply(scores, n_base, state_len)


def normalise(scores: torch.Tensor, n_base: int, state_len: int):
    """Globally normalise the scores so that logZ == 0 (reference
    crf/model.py:48-49)."""
    T = scores.shape[0]
    return scores - (logz(scores, n_base, state_len) / T)[None, :, None]


def prepare_ctc_scores(scores: torch.Tensor, targets: torch.Tensor,
                       n_base: int, state_len: int):
    """Gather the stay/move lattice scores of target sequences (reference
    crf/model.py:102-116): targets [N, L] CTC codes (blank 0, bases
    1..n_base) -> stay [T, N, n] and move [T, N, n-1], n = L - state_len + 1.
    One ``torch.gather`` over the score columns."""
    T = scores.shape[0]
    zt = (targets.long() - 1).clamp(min=0)
    n = targets.shape[1] - (state_len - 1)
    stay_state = sum(zt[:, i:n + i] * n_base ** (state_len - i - 1)
                     for i in range(state_len))
    stay_idx = stay_state * (n_base + 1)                 # [N, n]
    move_idx = stay_idx[:, 1:] + zt[:, :n - 1] + 1       # [N, n-1]
    idx = torch.cat([stay_idx, move_idx], 1)
    both = torch.gather(scores, 2, idx[None].expand(T, -1, -1))
    return both[:, :, :n], both[:, :, n:]


def _ctc_step(alpha, stay_t, move_t):
    """One lattice step: stay at a position or advance by one."""
    stayed = alpha + stay_t
    moved = alpha[:, :-1] + move_t
    upper = _lse(torch.stack([stayed[:, 1:], moved], -1), -1)
    return torch.cat([stayed[:, :1], upper], 1)


def lattice_forward(stay: torch.Tensor, move: torch.Tensor,
                    lengths: torch.Tensor):
    """Plain version of K6a: the stay/move lattice's forward scan.  Returns
    (alphas [T, N, n], alpha_t before step t; logZ [N] read at position
    clamp(length-1, 0, n-1) of alpha_T)."""
    T, N, n = stay.shape
    alpha = stay.new_full((N, n), _NEG_INF)
    alpha[:, 0] = 0.0
    alphas = torch.empty_like(stay)
    for t in range(T):
        alphas[t] = alpha
        alpha = _ctc_step(alpha, stay[t], move[t])
    idx = (lengths.long() - 1).clamp(0, n - 1)[:, None]
    return alphas, alpha.gather(1, idx)[:, 0]


def lattice_backward(stay: torch.Tensor, move: torch.Tensor,
                     lengths: torch.Tensor, alphas: torch.Tensor,
                     logz: torch.Tensor, ct: torch.Tensor):
    """Plain version of K6b: the lattice's backward scan (beta_T = 0 at
    position length-1) and the edge posteriors of stay and move times the
    cotangent ``ct`` [N] (``crf.py::_ctc_lattice_bwd``).  Returns (d_stay
    [T, N, n], d_move [T, N, n-1])."""
    T, N, n = stay.shape
    pos = torch.arange(n, device=stay.device)[None, :]
    beta = torch.full((N, n), _NEG_INF, dtype=stay.dtype,
                      device=stay.device)
    beta = beta.masked_fill(pos == (lengths.long() - 1)[:, None], 0.0)
    betas = torch.empty_like(stay)       # beta_{t+1}
    for t in range(T - 1, -1, -1):
        betas[t] = beta
        stay_term = stay[t] + beta
        move_term = move[t] + beta[:, 1:]
        beta = torch.cat([torch.logaddexp(stay_term[:, :-1], move_term),
                          stay_term[:, -1:]], 1)
    norm = ct[None, :, None]
    d_stay = torch.exp(alphas + stay + betas - logz[None, :, None]) * norm
    d_move = torch.exp(alphas[:, :, :-1] + move + betas[:, :, 1:]
                       - logz[None, :, None]) * norm
    return d_stay, d_move


class _CTCLatticeLogZ(torch.autograd.Function):
    """logZ [N] of the stay/move lattice, read at position length-1 (K6a),
    with the explicit backward of ``crf.py::_ctc_lattice_bwd`` (K6b): the
    edge posteriors of stay and move times the cotangent.  The forward
    keeps the alphas that the JAX backward recomputes, and packs stay and
    move once for both kernels (``crf_cuda.lattice_pack``)."""

    @staticmethod
    def forward(ctx, stay, move, lengths):
        from xna_basecaller_tpu_torch.ops import crf_cuda
        stay, move = crf_cuda.lattice_unpack(
            crf_cuda.lattice_pack(stay, move), stay.shape[2])
        alphas, lz = crf_cuda.lattice_forward(stay, move, lengths)
        ctx.save_for_backward(stay, move, lengths, alphas, lz)
        return lz

    @staticmethod
    def backward(ctx, ct):
        from xna_basecaller_tpu_torch.ops import crf_cuda
        d_stay, d_move = crf_cuda.lattice_backward(*ctx.saved_tensors, ct)
        return d_stay, d_move, None


def ctc_lattice_logz(stay: torch.Tensor, move: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """logZ of the stay/move alignment lattice (seqdist ctc_simple.logZ, as
    the reference calls it at crf/model.py:122): paths start at position 0,
    each frame stays or advances one position, and end at length-1."""
    return _CTCLatticeLogZ.apply(stay, move, lengths)


def ctc_loss(scores: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor, n_base: int, state_len: int,
             loss_clip: float | None = None, reduction: str = "mean",
             normalise_scores: bool = True) -> torch.Tensor:
    """CTC-CRF loss -(logZ_ctc - logZ_full) / target_length (reference
    crf/model.py:118-131), in f32.  ``targets`` [N, L] CTC codes,
    ``target_lengths`` [N]."""
    scores = scores.float()
    if normalise_scores:
        scores = normalise(scores, n_base, state_len)
    stay, move = prepare_ctc_scores(scores, targets, n_base, state_len)
    lz = ctc_lattice_logz(stay, move, target_lengths + 1 - state_len)
    loss = -(lz / target_lengths)
    if loss_clip:
        loss = loss.clamp(0.0, loss_clip)
    if reduction == "mean":
        return loss.mean()
    if reduction in ("none", None):
        return loss
    raise ValueError(f"Unknown reduction type {reduction}")


def complement_permutation(alphabet: str) -> list[int]:
    """perm[i] = the base index (0-based, blank excluded) of the complement
    of ``alphabet[i + 1]``, through ``core.alphabet.COMPLEMENT`` (A<->T,
    C<->G, X<->Y).  Raises ``ValueError`` naming the base whose complement
    the alphabet lacks (NACGTX: X, whose complement Y is missing)."""
    bases = alphabet[1:]
    perm = []
    for b in bases:
        c = COMPLEMENT.get(b)
        if c is None or c not in bases:
            raise ValueError(
                f"alphabet {alphabet!r} is not closed under complement: "
                f"base {b!r} has no complement ({c!r}) in it")
        perm.append(bases.index(c))
    return perm


@lru_cache(maxsize=None)
def _revcomp_columns(n_base: int, state_len: int,
                     alphabet: str) -> torch.Tensor:
    """The column gather of ``reverse_complement``: out[..., j] =
    scores[..., cols[j]] on the time-reversed scores.  Built by running
    the k-mer reversal of the JAX ``reverse_complement`` over column
    indices, each base axis and the emission axis complemented through
    ``complement_permutation`` where that function flips them."""
    perm = torch.tensor(complement_permutation(alphabet))
    if len(perm) != n_base:
        raise ValueError(f"alphabet {alphabet!r} has {len(perm)} bases, "
                         f"the scores {n_base}")
    idx = torch.arange((n_base + 1) * n_base ** state_len).reshape(
        (n_base,) * state_len + (n_base + 1,))
    for axis in range(state_len):
        idx = idx.index_select(axis, perm)
    idx = idx.index_select(state_len, torch.cat([perm.new_zeros(1),
                                                 perm + 1]))
    blanks = idx[..., 0].permute(tuple(range(state_len - 1, -1, -1)))
    emissions = idx[..., 1:].permute(
        tuple(range(state_len - 2, -1, -1)) + (state_len, state_len - 1))
    return torch.cat([blanks.reshape(-1, 1),
                      emissions.reshape(-1, n_base)], -1).reshape(-1)


def reverse_complement(scores: torch.Tensor, n_base: int, state_len: int,
                       alphabet: str | None = None):
    """Reverse-complement a score tensor for R-strand decoding: reverses
    time and the k-mer base order within each state (as the JAX
    ``reverse_complement``, reference crf/model.py:78-90), and complements
    each base through the alphabet's complement map.  ``alphabet``
    defaults to the canonical one of ``n_base`` bases (``BASES``'s
    prefix).

    Deliberately not JAX's: JAX complements base i as n_base - 1 - i,
    which is the complement for NACGT (so NACGT scores are bit-equal to
    JAX's) and pairs A<->Y, C<->X, G<->T for NACGTXY."""
    if alphabet is None:
        alphabet = BASES[:n_base + 1]
    cols = _revcomp_columns(n_base, state_len, alphabet)
    return scores.flip(0).index_select(2, cols.to(scores.device))


def ctc_viterbi_alignments(stay: torch.Tensor, move: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Most-likely alignment through the stay/move lattice
    (seqdist.ctc_simple.viterbi_alignments, reference crf/model.py:133-135):
    a one-hot [T, N, n] of stay's dtype marking the occupied position at
    each frame on the best path, which ends at position length-1; a move
    is taken only where it scores strictly more than the stay."""
    T, N, n = stay.shape
    alpha = stay.new_full((N, n), _NEG_INF)
    alpha[:, 0] = 0.0
    took = torch.empty(T, N, max(n - 1, 0), dtype=torch.bool,
                       device=stay.device)
    for t in range(T):
        stayed = alpha + stay[t]
        moved = alpha[:, :-1] + move[t]
        took[t] = moved > stayed[:, 1:]
        upper = torch.where(took[t], moved, stayed[:, 1:])
        alpha = torch.cat([stayed[:, :1], upper], 1)
    pos = (lengths.long() - 1).clamp(0, n - 1).to(stay.device)
    rows = torch.arange(N, device=stay.device)
    positions = torch.empty(T, N, dtype=torch.long, device=stay.device)
    for t in range(T - 1, -1, -1):
        positions[t] = pos
        if n > 1:
            moved = (pos > 0) & took[t, rows, (pos - 1).clamp(min=0)]
            pos = torch.where(moved, pos - 1, pos)
    return torch.nn.functional.one_hot(positions, n).to(stay.dtype)


def _hash_step(h: torch.Tensor, p: int, label: torch.Tensor):
    """(h * p + label) mod 2**32 of uint32 hashes held in int64: the
    product is split at 16 bits, so that no partial product passes 2**49
    (int64 multiplication may not wrap)."""
    lo = (h & 0xFFFF) * p
    hi = ((h >> 16) * p) & 0xFFFF
    return (lo + (hi << 16) + label) & 0xFFFFFFFF


def _top(x: torch.Tensor, k: int):
    """The k largest of each row, descending, the lower index first among
    equal values, as ``jax.lax.top_k``: (values, indices)."""
    values, idx = torch.sort(x, stable=True, dim=-1, descending=True)
    return values[..., :k], idx[..., :k]


def _beam_merge_topk(state, h1, h2, score, beam_width: int):
    """Collapse the candidates [N, M] of one identity (state and both
    sequence hashes) by log-sum-exp into the first of them, then keep the
    top ``beam_width``: (indices into the candidates, merged scores),
    ``crf.py::_beam_merge_topk`` of the JAX package."""
    same = ((h1[:, :, None] == h1[:, None, :])
            & (h2[:, :, None] == h2[:, None, :])
            & (state[:, :, None] == state[:, None, :]))          # [N, M, M]
    merged = _lse(torch.where(same, score[:, None, :], _NEG_INF), -1)
    m = score.shape[1]
    idx = torch.arange(m, device=score.device)
    first = torch.where(same, idx, m).amin(-1)
    merged = torch.where(first == idx, merged, _NEG_INF)
    top_score, top = _top(merged, beam_width)
    return top, top_score


def beam_search(scores: torch.Tensor, alphas: torch.Tensor,
                betas: torch.Tensor, logz: torch.Tensor, n_base: int,
                state_len: int, beam_width: int = 8):
    """Plain version of the beam kernel (``csrc/crf_beam.cu``): the
    path-collapsing beam search over the edge log-posteriors alpha_t[pred]
    + score + beta_{t+1} - logZ, from the scores [T, N, C] f32, the
    partials [T+1, N, n_state] and logZ [N] (JAX's ``decode_beam`` after
    its scans, ``crf.py:660-741``).  Returns (labels [N, T] int8, 0 = stay,
    labels at their move frame; best_score [N] f32, the winning sequence's
    merged log posterior)."""
    return _beam_search(scores, alphas, betas, logz, n_base, state_len,
                        beam_width)[:2]


def _beam_search(scores, alphas, betas, logz, n_base, state_len,
                 beam_width):
    """``beam_search``, which also returns the final beams' scores merged
    by sequence [N, B] and the mask [N, B] of the beams that hold the
    winning sequence."""
    T, N, _ = scores.shape
    Ms, ns = _split(scores, n_base, state_len)
    nsd, nb1, B = ns // n_base, n_base + 1, beam_width
    dev = scores.device

    def edge(t):   # [N, ns, nb1]
        a = alphas[t]
        return torch.cat([a[..., None], _expand_pred(a, n_base, ns)], -1) \
            + Ms[t] + betas[t + 1][..., None] - logz[:, None, None]

    # t = 0: every (state, column) pair is a beam identity of its own
    e0 = edge(0).reshape(N, ns * nb1)
    if e0.shape[1] < B:
        e0 = torch.cat([e0, e0.new_full((N, B - e0.shape[1]), _NEG_INF)], 1)
    score, idx0 = _top(e0, B)
    idx0 = idx0.clamp(max=ns * nb1 - 1)
    label0 = idx0 % nb1
    state = idx0 // nb1
    h1 = h2 = label0
    parents, labels = [], []
    cols = torch.arange(n_base, device=dev)
    c_parent = torch.arange(B, device=dev).repeat_interleave(nb1)
    for t in range(1, T):
        s2 = edge(t).reshape(N, ns * nb1)
        dropped = state // nsd
        lab = dropped + 1                                    # [N, B]
        stay = score + s2.gather(1, state * nb1)
        new_st = (state % nsd)[..., None] * n_base + cols    # [N, B, nb]
        mv = score[..., None] + s2.gather(
            1, (new_st * nb1 + lab[..., None]).reshape(N, -1)).reshape(
                N, B, n_base)
        c_state = torch.cat([state[..., None], new_st], -1).reshape(N, -1)
        c_score = torch.cat([stay[..., None], mv], -1).reshape(N, -1)
        c_h1 = torch.cat([h1[..., None], _hash_step(h1, _HASH_P1, lab)[
            ..., None].expand(N, B, n_base)], -1).reshape(N, -1)
        c_h2 = torch.cat([h2[..., None], _hash_step(h2, _HASH_P2, lab)[
            ..., None].expand(N, B, n_base)], -1).reshape(N, -1)
        c_label = torch.cat([torch.zeros_like(lab)[..., None],
                             lab[..., None].expand(N, B, n_base)],
                            -1).reshape(N, -1)
        top, score = _beam_merge_topk(c_state, c_h1, c_h2, c_score, B)
        state, h1, h2 = (x.gather(1, top) for x in (c_state, c_h1, c_h2))
        parents.append(c_parent[top])
        labels.append(c_label.gather(1, top))

    # the end: merge the beams across states by sequence alone
    same = ((h1[:, :, None] == h1[:, None, :])
            & (h2[:, :, None] == h2[:, None, :]))
    merged = _lse(torch.where(same, score[:, None, :], _NEG_INF), -1)
    best = merged.argmax(-1)                                 # first maximum
    best_score = merged.amax(-1)
    out = torch.empty(N, T, dtype=torch.int8, device=dev)
    cur = best[:, None]
    for t in range(T - 1, 0, -1):
        out[:, t] = labels[t - 1].gather(1, cur)[:, 0].to(torch.int8)
        cur = parents[t - 1].gather(1, cur)
    out[:, 0] = label0.gather(1, cur)[:, 0].to(torch.int8)
    return out, best_score, merged, same[torch.arange(N, device=dev), best]


def decode_beam(scores: torch.Tensor, n_base: int, state_len: int,
                beam_width: int = 8):
    """Path-collapsing beam decode in plain PyTorch (JAX's ``decode_beam``):
    [T, N, C] -> (labels [N, T] int8, best_score [N]), in f32, on the
    forward and backward partials with logZ from the alphas."""
    scores = scores.float()
    alphas = forward_scores(scores, n_base, state_len)
    betas = backward_scores(scores, n_base, state_len)
    return beam_search(scores, alphas, betas, logz_from_alphas(alphas),
                       n_base, state_len, beam_width)


@dataclass(frozen=True)
class CTCCRF:
    """The JAX ``CTCCRF`` bundle: alphabet bookkeeping, logZ, the loss, the
    Viterbi path and the batch decodes."""

    state_len: int
    alphabet: str

    @property
    def n_base(self) -> int:
        return len(self.alphabet) - 1

    @property
    def n_state(self) -> int:
        return self.n_base ** self.state_len

    @property
    def n_score(self) -> int:
        return len(self.alphabet) * self.n_state

    def logZ(self, scores, semiring: str = LOG):
        return logz(scores, self.n_base, self.state_len, semiring)

    def normalise(self, scores):
        return normalise(scores, self.n_base, self.state_len)

    def posteriors(self, scores, semiring: str = LOG):
        return posteriors(scores, self.n_base, self.state_len, semiring)

    def viterbi(self, scores):
        return viterbi_path(scores, self.n_base, self.state_len)

    def ctc_loss(self, scores, targets, target_lengths, **kw):
        return ctc_loss(scores, targets, target_lengths, self.n_base,
                        self.state_len, **kw)

    def reverse_complement(self, scores):
        return reverse_complement(scores, self.n_base, self.state_len,
                                  self.alphabet)

    def ctc_viterbi_alignments(self, scores, targets, target_lengths):
        """Reference crf/model.py:133-135."""
        stay, move = prepare_ctc_scores(scores, targets, self.n_base,
                                        self.state_len)
        return ctc_viterbi_alignments(stay, move,
                                      target_lengths + 1 - self.state_len)

    def decode_batch(self, scores) -> list[str]:
        """Decode [T, N, C] scores to one string per row: through the CUDA
        kernels K2a/b/c for scores on the card, the plain decode on the
        CPU."""
        from xna_basecaller_tpu_torch.ops.crf_cuda import decode_paths_cuda
        paths = decode_paths_cuda(scores, self.n_base, self.state_len)
        return [self.path_to_str(p) for p in paths.cpu().numpy()]

    def decode_beam_batch(self, scores, beam_width: int = 8) -> list[str]:
        """The beam decode of [T, N, C] scores, one string per row: K4, K2a
        and the beam kernel for scores on the card, the plain decode on
        the CPU."""
        from xna_basecaller_tpu_torch.ops.crf_cuda import decode_beam_cuda
        paths, _ = decode_beam_cuda(scores, self.n_base, self.state_len,
                                    beam_width)
        return [self.path_to_str(p) for p in paths.cpu().numpy()]

    def path_to_str(self, path) -> str:
        alpha = np.frombuffer("".join(self.alphabet).encode(), dtype="u1")
        path = np.asarray(path)
        return alpha[path[path != 0]].tobytes().decode()
