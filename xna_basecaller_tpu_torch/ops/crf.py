"""k-mer CTC-CRF decode in plain PyTorch.

Port of the decode side of ``xna_basecaller_tpu/ops/crf.py``: the
log-semiring forward and backward scans, the Viterbi decode over the log
edge posteriors, ``reverse_complement`` and ``CTCCRF.path_to_str``.  The
loss, the Max semiring, q-scores and the beam decoder are not ported yet.

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
    """All forward partials alpha_t: [T, N, C] -> [T+1, N, n_state]."""
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
    beta_T = 0.  Plain version of K2a."""
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
    """Alphabet bookkeeping of the CRF (the JAX ``CTCCRF``, decode side)."""

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

    def path_to_str(self, path) -> str:
        alpha = np.frombuffer("".join(self.alphabet).encode(), dtype="u1")
        path = np.asarray(path)
        return alpha[path[path != 0]].tobytes().decode()
