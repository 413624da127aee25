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

The int8 path of ``--quantize`` (``lstm_pallas.py:190-323``):
``quantize_w_hh`` (per-column symmetric int8 weights), ``int8_matmul`` (int8
x int8 -> int32 products with a dynamic per-tensor activation scale; the
input projections and the CRF head) and ``lstm_recurrence_int8``, the plain
version of the CUDA kernel K7, which requantizes h to int8 every step.
"""

from __future__ import annotations

import torch

# |acc| <= 127 * 127 * K: integer-valued f32 sums are exact below 2 ** 24
_EXACT_F32_DEPTH = 2 ** 24 // (127 * 127)


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


def quantize_w_hh(w: torch.Tensor):
    """Per-column symmetric int8 quantization (``lstm_pallas.py:197-202``):
    w [K, M] -> (w_q int8 [K, M], scale f32 [M]) with w ~= w_q * scale.
    ``scale = max(max_k |w|, 1e-8) / 127``; ``w_q = clip(round(w / scale))``
    rounds half to even, as ``jnp.round`` does.  127 is a 0-dim tensor: on
    the card PyTorch divides by a Python number as a product with its
    reciprocal, which is one ulp off in some columns."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(0), min=1e-8) / torch.full(
        (), 127.0, device=w.device)
    w_q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return w_q, scale


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] float, w_q int8 [K, M], w_scale f32 [M] -> f32 [..., M]
    (``lstm_pallas.py:205-218``): x is quantized with one dynamic scale,
    ``xs = max(max |x|, 1e-8) * (1/127)`` over the whole tensor, the
    product accumulates exactly in int32, and ``out = acc * (xs *
    w_scale)``, in JAX's op order.

    The product is ``torch._int_mm``: cuBLASLt on the card, which takes
    more than 16 rows and K, M multiples of 8 only.  So any other shape (a
    5-letter model's head has 625 columns) is padded with zeros to the
    next such one, on every device, and the result sliced back: zeros
    change neither ``xs`` nor any int32 sum, so the result is that of the
    unpadded product, bit for bit."""
    lead, K = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, K).float()
    rows, M = xf.shape[0], w_q.shape[1]
    xs = torch.clamp(xf.abs().amax(), min=1e-8) * (1.0 / 127.0)
    x_q = torch.round(xf / xs).clamp(-127, 127).to(torch.int8)
    pad_k, pad_m = -K % 8, -M % 8
    x_q = torch.nn.functional.pad(x_q, (0, pad_k, 0, max(17 - rows, 0)))
    # w_q column-major ([M, K] contiguous, seen transposed): the TN operand
    # layout of cuBLASLt's int8 GEMM
    w_t = torch.nn.functional.pad(w_q.t(), (0, pad_k, 0, pad_m)).contiguous()
    acc = torch._int_mm(x_q, w_t.t())[:rows, :M]
    return (acc.float() * (xs * w_scale)).reshape(*lead, -1)


def lstm_recurrence_int8(xp: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """Plain version of K7 (``lstm_pallas.py::_make_int8_kernel``): xp
    [T, N, 4H] f32 or bf16, w_q int8 [H, 4H], scale f32 [4H] -> ys
    [T, N, H] in xp's dtype.  Per step, in f32:

        h_q = clip(round(h * 127), -127, 127)
        gates = xp[t] + (h_q @ w_q) * deq,   deq = scale * f32(1/127)
        c = f * c + i * g,  h = o * tanh(c),  ys[t] = h in xp's dtype

    The product is exact: integer-valued f32 sums stay below 2 ** 24 for
    H <= 1040.

    The TPU kernel runs two steps per grid iteration and keeps h between
    iterations in a scratch of xp's dtype (``lstm_pallas.py:234-252,
    278``), so in bf16 the h that step s requantizes was rounded to bf16
    when s is even and is the f32 h when s is odd (s counts steps in walk
    order, from the end for ``reverse``).  This version and K7 do the same;
    in f32 nothing is rounded."""
    T, N, H4 = xp.shape
    H = H4 // 4
    if H > _EXACT_F32_DEPTH:
        raise ValueError(f"lstm_recurrence_int8: H={H} > "
                         f"{_EXACT_F32_DEPTH} (the exact f32 product)")
    w = w_q.float()
    deq = scale * (1.0 / 127.0)
    h = torch.zeros(N, H, dtype=torch.float32, device=xp.device)
    c = torch.zeros_like(h)
    ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)
    for s, t in enumerate(_walk(T, reverse)):
        hh = h.to(xp.dtype).float() if s % 2 == 0 else h
        h_q = torch.round(hh * 127.0).clamp(-127, 127)
        gates = xp[t].float() + (h_q @ w) * deq
        i, f, g, o = gates.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h.to(xp.dtype)
    return ys
