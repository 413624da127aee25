"""k-mer CTC-CRF in plain PyTorch: the decode and the training loss.

Port of ``xna_basecaller_tpu/ops/crf.py``: the log-semiring forward and
backward scans, the Viterbi decode over the log edge posteriors,
``reverse_complement``, and the loss side of the CRF: ``logz`` (a
``torch.autograd.Function`` whose backward is the explicit edge
posteriors, as ``logz_fwd``'s custom VJP), ``posteriors``, ``normalise``,
``prepare_ctc_scores``, the stay/move lattice logZ with its explicit
backward, and ``ctc_loss``.  The two autograd Functions run the CUDA
kernels of ``ops/crf_cuda.py`` for tensors on the card, as the JAX
package's default (Pallas) loss does, and their plain versions here for
tensors on the CPU: ``forward_scores`` (K4), ``backward_scores`` (K5a),
``edge_posteriors`` (K5b), ``lattice_forward`` (K6a) and
``lattice_backward`` (K6b).  The Max semiring, q-scores and the beam
decoder are not ported yet.

Scores are [T, N, C] with C = n_state * (n_base + 1); reshaped to
[T, N, n_state, n_base + 1], column 0 is the stay transition and column
1 + i the move into the state that dropped base i.

The decode is split as the CUDA kernels of ``ops/crf_cuda.py`` split it,
and these functions are their plain versions: ``backward_scores`` (K2a;
logZ = logsumexp(beta_0), as ``crf_pallas.py:341``), ``forward_viterbi``
(K2b) and ``viterbi_traceback`` (K2c).  Each step keeps the op order of
the JAX ``decode_paths`` (``crf.py:331-341`` there).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_NEG_INF = -1e38   # finite "zero" of the log semiring; avoids inf - inf


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log(sum(exp(x))) over ``dim`` as max + log(sum(exp(x - max)))."""
    m = x.amax(dim, keepdim=True)
    return (m + torch.log(torch.exp(x - m).sum(dim, keepdim=True))
            ).squeeze(dim)


def _expand_pred(alpha: torch.Tensor, n_base: int, n_state: int):
    """alpha [N, n_state] -> pred [N, n_state, n_base] with
    pred[n, j, i] = alpha[n, i * (n_state // n_base) + j // n_base]."""
    N = alpha.shape[0]
    nsd = n_state // n_base
    a = alpha.reshape(N, n_base, nsd, 1).expand(N, n_base, nsd, n_base)
    return a.reshape(N, n_base, n_state).transpose(1, 2)


def _bwd_step(beta: torch.Tensor, ms_t: torch.Tensor, n_base: int,
              n_state: int) -> torch.Tensor:
    """beta_{t+1} [N, ns] -> beta_t: the stay column plus, for state
    k = i*nsd + m, lse_b(Ms[t, m*n_base + b, 1 + i] + beta[m*n_base + b])."""
    N = beta.shape[0]
    nsd = n_state // n_base
    mr = ms_t[..., 1:].reshape(N, nsd, n_base, n_base)   # [n, m, b, i]
    br = beta.reshape(N, nsd, n_base)
    summed = _lse(mr + br[..., None], dim=2)             # [n, m, i]
    move = summed.transpose(1, 2).reshape(N, n_state)    # k = i*nsd + m
    stay = ms_t[..., 0] + beta
    return _lse(torch.stack([stay, move], -1), -1)


def _split(scores: torch.Tensor, n_base: int, state_len: int):
    T, N, _ = scores.shape
    ns = n_base ** state_len
    return scores.reshape(T, N, ns, n_base + 1), ns


def forward_scores(scores: torch.Tensor, n_base: int, state_len: int):
    """All forward partials alpha_t: [T, N, C] -> [T+1, N, n_state], with
    alpha_0 = 0.  Plain version of K4."""
    Ms, ns = _split(scores, n_base, state_len)
    alpha = scores.new_zeros(scores.shape[1], ns)
    out = [alpha]
    for ms_t in Ms:
        stay = alpha + ms_t[..., 0]
        move = _expand_pred(alpha, n_base, ns) + ms_t[..., 1:]
        alpha = _lse(torch.cat([stay[..., None], move], -1), -1)
        out.append(alpha)
    return torch.stack(out)


def backward_scores(scores: torch.Tensor, n_base: int, state_len: int):
    """All backward partials beta_t: [T, N, C] -> [T+1, N, n_state], with
    beta_T = 0.  Plain version of K2a, which is K5a too."""
    Ms, ns = _split(scores, n_base, state_len)
    T = scores.shape[0]
    betas = scores.new_empty(T + 1, scores.shape[1], ns)
    betas[T] = 0.0
    for t in range(T - 1, -1, -1):
        betas[t] = _bwd_step(betas[t + 1], Ms[t], n_base, ns)
    return betas


def logz_from_betas(betas: torch.Tensor) -> torch.Tensor:
    """logZ [N] = logsumexp(beta_0): alpha_0 == 0, so this is the same
    partition function the forward scan ends with."""
    return _lse(betas[0], -1)


def forward_viterbi(scores: torch.Tensor, betas: torch.Tensor,
                    logz: torch.Tensor, n_base: int, state_len: int):
    """Plain version of K2b: the forward scan fused with Viterbi over
    log(exp(alpha[pred] + score + beta_{t+1} - logZ) + 1e-8).

    Returns (backpointers [T, N, n_state] uint8, v_final [N, n_state]);
    a backpointer is the chosen column k (0 = stay), the first maximum."""
    Ms, ns = _split(scores, n_base, state_len)
    T, N = scores.shape[:2]
    alpha = scores.new_zeros(N, ns)
    v = scores.new_zeros(N, ns)
    bp = torch.empty(T, N, ns, dtype=torch.uint8, device=scores.device)
    for t in range(T):
        ms_t = Ms[t]
        pred_a = _expand_pred(alpha, n_base, ns)
        edge = torch.cat([alpha[..., None], pred_a], -1) + ms_t \
            + betas[t + 1][..., None] - logz[:, None, None]
        s2 = torch.log(torch.exp(edge) + 1e-8)
        stay = v + s2[..., 0]
        move = _expand_pred(v, n_base, ns) + s2[..., 1:]
        full = torch.cat([stay[..., None], move], -1)
        bp[t] = full.argmax(-1).to(torch.uint8)
        v = full.amax(-1)
        alpha = _lse(torch.cat([(alpha + ms_t[..., 0])[..., None],
                                pred_a + ms_t[..., 1:]], -1), -1)
    return bp, v


def viterbi_traceback(bp: torch.Tensor, v_final: torch.Tensor,
                      n_base: int, state_len: int) -> torch.Tensor:
    """Plain version of K2c: labels [N, T] int8 from argmax(v_final) back
    over the backpointers; j <- (k-1)*nsd + j // n_base on a move."""
    T, N, ns = bp.shape
    nsd = ns // n_base
    j = v_final.argmax(-1)
    rows = torch.arange(N, device=bp.device)
    labels = torch.empty(N, T, dtype=torch.int8, device=bp.device)
    for t in range(T - 1, -1, -1):
        k = bp[t, rows, j].long()
        labels[:, t] = k.to(torch.int8)
        j = torch.where(k == 0, j, (k - 1) * nsd + j // n_base)
    return labels


def decode_paths(scores: torch.Tensor, n_base: int, state_len: int):
    """Full decode chain in plain PyTorch: scores -> labels [N, T] int8
    (0 = stay, k = alphabet[k]), in f32."""
    scores = scores.float()
    betas = backward_scores(scores, n_base, state_len)
    bp, v_final = forward_viterbi(scores, betas, logz_from_betas(betas),
                                  n_base, state_len)
    return viterbi_traceback(bp, v_final, n_base, state_len)


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
               alphas: torch.Tensor | None = None) -> torch.Tensor:
    """Posterior transition probabilities [T, N, C], d logZ / d scores.
    ``alphas`` are the forward partials when the caller has them."""
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


def logz(scores: torch.Tensor, n_base: int, state_len: int) -> torch.Tensor:
    """Partition function of the CRF, [T, N, C] -> [N] (alpha_0 = beta_T =
    0 for every state), differentiable."""
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
    keeps the alphas that the JAX backward recomputes."""

    @staticmethod
    def forward(ctx, stay, move, lengths):
        from xna_basecaller_tpu_torch.ops import crf_cuda
        stay, move = stay.contiguous(), move.contiguous()
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


def reverse_complement(scores: torch.Tensor, n_base: int, state_len: int):
    """Reverse-complement a score tensor for R-strand decoding: reverses
    time and the k-mer base order within each state, and complements by
    index flips (the JAX ``reverse_complement``, reference
    crf/model.py:78-90)."""
    T, N, _ = scores.shape
    s = scores.reshape((T, N) + (n_base,) * state_len + (n_base + 1,))
    blanks = s[..., 0].permute(
        (0, 1) + tuple(range(state_len + 1, 1, -1))
    ).reshape(T, N, -1, 1).flip((0, 2))
    emissions = s[..., 1:].permute(
        (0, 1) + tuple(range(state_len, 1, -1))
        + (state_len + 2, state_len + 1)
    ).reshape(T, N, -1, n_base).flip((0, 2, 3))
    return torch.cat([blanks, emissions], -1).reshape(T, N, -1)


@dataclass(frozen=True)
class CTCCRF:
    """The JAX ``CTCCRF`` bundle: alphabet bookkeeping, logZ, the loss and
    the batch decode."""

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

    def logZ(self, scores):
        return logz(scores, self.n_base, self.state_len)

    def normalise(self, scores):
        return normalise(scores, self.n_base, self.state_len)

    def posteriors(self, scores):
        return posteriors(scores, self.n_base, self.state_len)

    def ctc_loss(self, scores, targets, target_lengths, **kw):
        return ctc_loss(scores, targets, target_lengths, self.n_base,
                        self.state_len, **kw)

    def decode_batch(self, scores) -> list[str]:
        """Decode [T, N, C] scores to one string per row: through the CUDA
        kernels K2a/b/c for scores on the card, the plain decode on the
        CPU."""
        from xna_basecaller_tpu_torch.ops.crf_cuda import decode_paths_cuda
        paths = decode_paths_cuda(scores, self.n_base, self.state_len)
        return [self.path_to_str(p) for p in paths.cpu().numpy()]

    def path_to_str(self, path) -> str:
        alpha = np.frombuffer("".join(self.alphabet).encode(), dtype="u1")
        path = np.asarray(path)
        return alpha[path[path != 0]].tobytes().decode()
