"""LSTM layers in plain PyTorch: the hoisted input projection and the
per-step recurrence.

Port of ``xna_basecaller_tpu/ops/lstm.py``.  Gate order is torch's
(i, f, g, o), there is no ``bias_hh``, and weights keep the JAX layout:
``w_ih [in, 4H]``, ``w_hh [H, 4H]``, ``bias [4H]``.

``lstm_recurrence`` is the plain version of the CUDA kernel K1
(``ops/lstm_cuda.py``) and follows the numerics of the Pallas kernel that
K1 replaces (``lstm_pallas.py::_make_scan_kernel``): ``h @ W_hh`` is
accumulated in f32 and added to ``xp`` in f32, the cell state is f32, and
the hidden state is kept in ``xp``'s dtype.  (The JAX scan,
``ops/lstm.py:84-85`` there, rounds ``h @ W_hh`` to ``xp``'s dtype before
the add, so the two agree exactly only in f32.)
"""

from __future__ import annotations

import torch


def _orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    """A random [n, n] orthogonal matrix (QR of a Gaussian, sign-fixed)."""
    q, r = torch.linalg.qr(torch.randn(n, n, generator=generator))
    return q * torch.sign(torch.diagonal(r))[None, :]


def init_lstm_params(insize: int, size: int, generator: torch.Generator,
                     dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Per-gate orthogonal weights and 0.5 * truncated-normal(+-2) input
    bias: the distributions of ``ops/lstm.py::init_lstm_params`` in the
    JAX package (the numbers differ: torch draws them)."""
    n = max(insize, size)
    w_ih = torch.cat([_orthogonal(n, generator)[:insize, :size]
                      for _ in range(4)], dim=1)
    w_hh = torch.cat([_orthogonal(size, generator) for _ in range(4)], dim=1)
    bias = torch.empty(4 * size)
    torch.nn.init.trunc_normal_(bias, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return {"w_ih": w_ih.to(dtype), "w_hh": w_hh.to(dtype),
            "bias": (0.5 * bias).to(dtype)}


def input_projection(params, x: torch.Tensor) -> torch.Tensor:
    """x [T, N, in] -> xp [T, N, 4H] = x @ w_ih + bias, in x's dtype: one
    large matrix product over all timesteps (``ops/lstm.py:74-78``)."""
    T, N, _ = x.shape
    w = params["w_ih"].to(x.dtype)
    b = params["bias"].to(x.dtype)
    return torch.addmm(b, x.reshape(T * N, -1), w).reshape(T, N, -1)


def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """Plain version of K1: xp [T, N, 4H], w_hh [H, 4H] -> ys [T, N, H].

    ``reverse=True`` walks time from T-1 down to 0 and writes ys[t] at
    the step that read xp[t], which equals flipping time before and after
    a forward scan."""
    T, N, H4 = xp.shape
    H = H4 // 4
    w = w_hh.float()
    h = xp.new_zeros(N, H)
    c = torch.zeros(N, H, dtype=torch.float32, device=xp.device)
    ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xp[t].float() + h.float() @ w
        i, f, g, o = gates.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(xp.dtype)
        ys[t] = h
    return ys
