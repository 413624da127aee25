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

The trainable recurrence has two more plain versions, of K3a and K3b:
``lstm_recurrence_with_cells`` (the same walk, also returning the cell
states in ``xp``'s dtype, as ``_CELL_RESID_COMPUTE_DTYPE`` stores them by
default in JAX) and ``lstm_backward_dxp`` (the analytic reverse recursion
of ``lstm_pallas.py::_make_bwd_kernel``, step for step).
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


def _walk(T: int, reverse: bool):
    """The forward's time order: t = T-1 .. 0 when ``reverse``."""
    return range(T - 1, -1, -1) if reverse else range(T)


def lstm_recurrence_with_cells(xp: torch.Tensor, w_hh: torch.Tensor,
                               reverse: bool = False):
    """Plain version of K3a: xp [T, N, 4H], w_hh [H, 4H] -> (ys, cs), both
    [T, N, H] in xp's dtype; cs[t] is the (f32) cell state after step t,
    rounded to xp's dtype on the way out.

    ``reverse=True`` walks time from T-1 down to 0 and writes ys[t] at
    the step that read xp[t], which equals flipping time before and after
    a forward scan."""
    T, N, H4 = xp.shape
    H = H4 // 4
    w = w_hh.float()
    h = xp.new_zeros(N, H)
    c = torch.zeros(N, H, dtype=torch.float32, device=xp.device)
    ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)
    cs = torch.empty_like(ys)
    for t in _walk(T, reverse):
        gates = xp[t].float() + h.float() @ w
        i, f, g, o = gates.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(xp.dtype)
        ys[t] = h
        cs[t] = c
    return ys, cs


def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """Plain version of K1: xp [T, N, 4H], w_hh [H, 4H] -> ys [T, N, H]
    (the ys of ``lstm_recurrence_with_cells``)."""
    return lstm_recurrence_with_cells(xp, w_hh, reverse)[0]


def lstm_backward_dxp(dys: torch.Tensor, xp: torch.Tensor,
                      w_hh: torch.Tensor, ys: torch.Tensor, cs: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """Plain version of K3b: the gradient of the recurrence's xp, given the
    gradient ``dys`` of its output and the forward's ys and cs (all
    [T, N, H] but xp [T, N, 4H]) -> dxp [T, N, 4H] in xp's dtype.

    Walks the forward's steps in reverse; h_p and c_p are the step before's
    (ys, cs at t-1, or t+1 when ``reverse``; zero at the first step).  The
    gates are recomputed from the stored h_p; the arithmetic is f32, and
    dgates is rounded to xp's dtype, as written out and as the operand of
    the carry's product (``lstm_pallas.py:435-458``)."""
    T, N, H4 = xp.shape
    H = H4 // 4
    w = w_hh.float()
    zero = torch.zeros(N, H, dtype=torch.float32, device=xp.device)
    dh_c, dc_c = zero, zero
    dxp = torch.empty_like(xp)
    walk = list(_walk(T, reverse))
    for s in range(T - 1, -1, -1):
        t = walk[s]
        h_p = ys[walk[s - 1]].float() if s else zero
        c_p = cs[walk[s - 1]].float() if s else zero
        gates = xp[t].float() + h_p @ w
        gi, gf, gg, go = gates.chunk(4, dim=1)
        i, f, g, o = (torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg),
                      torch.sigmoid(go))
        tc = torch.tanh(cs[t].float())
        dh = dys[t].float() + dh_c
        do = dh * tc
        dc = dh * o * (1 - tc * tc) + dc_c
        di = dc * g
        df = dc * c_p
        dg = dc * i
        dgates = torch.cat([di * i * (1 - i), df * f * (1 - f),
                            dg * (1 - g * g), do * o * (1 - o)], 1
                           ).to(xp.dtype)
        dxp[t] = dgates
        dh_c = dgates.float() @ w.T
        dc_c = dc * f
    return dxp
