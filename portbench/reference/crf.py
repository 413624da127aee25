"""The k-mer CTC-CRF in plain PyTorch, f32: partition function, edge
posteriors, the Viterbi decode over them, and the CTC-CRF loss.

Scores are [T, N, n_state * (n_base + 1)]; viewed as [T, N, n_state,
n_base + 1], column 0 of state j is the stay and column 1 + i the move
into j from the state i * n_state / n_base + j // n_base (bonito's
``seqdist``).  A frame's label is the column taken (0 = stay).  The
decode is bonito's ``viterbi`` over log(exp(edge posterior) + 1e-8), its
paths free at both ends; the loss is bonito's ``CTC_CRF.ctc_loss``:
normalised scores, the stay/move lattice of the target's k-mers,
-(logZ_target - 0) / target length.  Frozen copies of the port's plain
scans (``ops/crf.py``) serve as the recursion.
"""

from __future__ import annotations

import torch

NEG = -1e38


def split(scores: torch.Tensor, n_base: int, state_len: int):
    T, N, _ = scores.shape
    return scores.reshape(T, N, n_base ** state_len, n_base + 1)


def lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    m = x.amax(dim, keepdim=True)
    return (m + torch.log(torch.exp(x - m).sum(dim, keepdim=True))
            ).squeeze(dim)


def expand_pred(v: torch.Tensor, n_base: int) -> torch.Tensor:
    """v [N, ns] -> [N, ns, n_base]: entry (j, i) is v at the predecessor
    of j through column 1 + i."""
    N, ns = v.shape
    nsd = ns // n_base
    a = v.reshape(N, n_base, nsd, 1).expand(N, n_base, nsd, n_base)
    return a.reshape(N, n_base, ns).transpose(1, 2)


def forward_scan(Ms: torch.Tensor, n_base: int, reduce=lse):
    """alpha_0 .. alpha_T [T+1, N, ns] (alpha_0 = 0)."""
    T, N, ns, _ = Ms.shape
    alpha = Ms.new_zeros(N, ns)
    out = [alpha]
    for t in range(T):
        alpha = reduce(torch.cat([(alpha + Ms[t, ..., 0])[..., None],
                                  expand_pred(alpha, n_base) + Ms[t, ..., 1:]],
                                 -1), -1)
        out.append(alpha)
    return torch.stack(out)


def backward_scan(Ms: torch.Tensor, n_base: int, reduce=lse):
    """beta_0 .. beta_T [T+1, N, ns] (beta_T = 0)."""
    T, N, ns, nb1 = Ms.shape
    nsd = ns // n_base
    beta = Ms.new_zeros(N, ns)
    out = [beta]
    for t in range(T - 1, -1, -1):
        mr = Ms[t, ..., 1:].reshape(N, nsd, n_base, n_base)
        move = reduce(mr + beta.reshape(N, nsd, n_base)[..., None], 2)
        move = move.transpose(1, 2).reshape(N, ns)
        beta = reduce(torch.stack([Ms[t, ..., 0] + beta, move], -1), -1)
        out.append(beta)
    return torch.stack(out[::-1])


def viterbi_weights(scores: torch.Tensor, n_base: int, state_len: int):
    """log(exp(alpha[pred] + score + beta_{t+1} - logZ) + 1e-8) [T, N, ns,
    n_base + 1]: the edge weights the decode maximises."""
    Ms = split(scores.float(), n_base, state_len)
    alphas = forward_scan(Ms, n_base)
    betas = backward_scan(Ms, n_base)
    logz = lse(betas[0], -1)
    pred = torch.cat([alphas[:-1, ..., None],
                      torch.stack([expand_pred(a, n_base)
                                   for a in alphas[:-1]])], -1)
    edge = pred + Ms + betas[1:, ..., None] - logz[None, :, None, None]
    return torch.log(torch.exp(edge) + 1e-8)


def amax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.amax(dim)


def max_marginals(w: torch.Tensor, n_base: int) -> torch.Tensor:
    """[T, N, n_base + 1]: for each frame and label, the largest sum of
    edge weights ``w`` over the paths that take that label there (free
    ends).  Its maximum over labels is the best path's value at every
    frame."""
    fwd = forward_scan(w, n_base, reduce=amax)
    bwd = backward_scan(w, n_base, reduce=amax)
    T = w.shape[0]
    out = []
    for t in range(T):
        pred = torch.cat([fwd[t][..., None], expand_pred(fwd[t], n_base)],
                         -1)
        out.append((pred + w[t] + bwd[t + 1][..., None]).amax(1))
    return torch.stack(out)


def normalise(scores: torch.Tensor, n_base: int, state_len: int):
    Ms = split(scores, n_base, state_len)
    logz = lse(forward_scan(Ms, n_base)[-1], -1)
    return scores - (logz / scores.shape[0])[None, :, None]


def ctc_loss(scores: torch.Tensor, targets: torch.Tensor,
             lengths: torch.Tensor, n_base: int,
             state_len: int) -> torch.Tensor:
    """Per-row CTC-CRF loss [N]: scores [T, N, C] f32, targets [N, L]
    codes 1..n_base (0 padding), lengths [N] >= state_len + 1."""
    scores = normalise(scores.float(), n_base, state_len)
    T, N, _ = scores.shape
    zt = (targets.long() - 1).clamp(min=0)
    n = targets.shape[1] - (state_len - 1)
    stay_state = sum(zt[:, i:n + i] * n_base ** (state_len - i - 1)
                     for i in range(state_len))
    stay_idx = stay_state * (n_base + 1)
    move_idx = stay_idx[:, 1:] + zt[:, :n - 1] + 1
    stay = torch.gather(scores, 2, stay_idx[None].expand(T, -1, -1))
    move = torch.gather(scores, 2, move_idx[None].expand(T, -1, -1))
    alpha = scores.new_full((N, n), NEG)
    alpha[:, 0] = 0.0
    for t in range(T):
        stayed = alpha + stay[t]
        moved = alpha[:, :-1] + move[t]
        upper = torch.logaddexp(stayed[:, 1:], moved)
        alpha = torch.cat([stayed[:, :1], upper], 1)
    pos = (lengths.long() - state_len).clamp(0, n - 1)[:, None]
    return -(alpha.gather(1, pos)[:, 0] / lengths.float())
