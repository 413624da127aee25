"""The plain forward of a bonito CRF-LSTM model, in f32.

conv(1->c1, k5) -> conv(c1->c2, k5) -> conv(c2->F, winlen, stride), each
followed by the activation, padding k // 2; then LSTM layers of width F in
alternating directions, the first reversed (gates i, f, g, o; one bias;
zero initial state); then the LinearCRFEncoder: tanh(x w + b) * scale with
a fixed blank score put in front of every group of n_base columns.  This
is bonito's ``crf/model.py`` as the paper's fork runs it (SURVEY section
2.2), written from that description and not from the port.

``mm`` replaces every matrix product of the LSTMs and the head (the
convolutions stay f32): the control runs it in a lower precision.  Call
``pin_f32`` first on the card: PyTorch would run f32 products in TF32.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from portbench.weights import model_dims

ACT = {"swish": F.silu, "relu": F.relu, "tanh": torch.tanh}


def pin_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product with both operands rounded to float8 e4m3 under one
    scale each (amax to the format's largest value 448), accumulated in
    f32: an fp8 GEMM with per-tensor scales."""
    def q(x):
        s = x.detach().abs().amax().clamp(min=1e-12) / 448.0
        xq = (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        # straight-through: the rounding's gradient is taken as 1
        return x + (xq - x).detach()
    return q(a) @ q(b)


MM = {"f32": f32_mm, "fp8": fp8_mm}


def conv_stack(w: dict, dims: dict, signal: torch.Tensor) -> torch.Tensor:
    """[N, T_sig] -> [T, N, F]."""
    act = ACT[dims["activation"]]
    x = signal[:, None, :]
    strides = (1, 1, dims["stride"])
    for i in range(3):
        k = w[f"conv.{i}.weight"]
        x = act(F.conv1d(x, k, w[f"conv.{i}.bias"], stride=strides[i],
                         padding=k.shape[-1] // 2))
    return x.permute(2, 0, 1)


def lstm(x: torch.Tensor, w_ih, w_hh, bias, reverse: bool, mm=f32_mm):
    """One LSTM layer: x [T, N, in] -> [T, N, H].  In f32 it is PyTorch's
    ``nn.LSTM`` (cuDNN on the card) on these weights, one bias; with
    another ``mm``, the step-by-step recurrence below."""
    if mm is f32_mm:
        return lstm_torch(x, w_ih, w_hh, bias, reverse)
    return lstm_steps(x, w_ih, w_hh, bias, reverse, mm)


def lstm_torch(x: torch.Tensor, w_ih, w_hh, bias, reverse: bool):
    from torch.func import functional_call
    H = w_hh.shape[0]
    layer = torch.nn.LSTM(w_ih.shape[0], H, device="meta")
    params = {"weight_ih_l0": w_ih.t().contiguous(),
              "weight_hh_l0": w_hh.t().contiguous(),
              "bias_ih_l0": bias, "bias_hh_l0": torch.zeros_like(bias)}
    xs = x.flip(0) if reverse else x
    with warnings.catch_warnings():
        # the weights are not one flat buffer: cuDNN copies them, as meant
        warnings.simplefilter("ignore", UserWarning)
        ys, _ = functional_call(layer, params, (xs,))
    return ys.flip(0) if reverse else ys


def lstm_steps(x: torch.Tensor, w_ih, w_hh, bias, reverse: bool,
               mm=f32_mm):
    """The recurrence step by step, every product through ``mm``."""
    T, N, _ = x.shape
    H = w_hh.shape[0]
    xp = (mm(x.reshape(T * N, -1), w_ih) + bias).reshape(T, N, 4 * H)
    h = x.new_zeros(N, H)
    c = x.new_zeros(N, H)
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xp[t] + mm(h, w_hh)
        i, f, g, o = gates.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out)


def crf_head(x: torch.Tensor, w: dict, dims: dict, mm=f32_mm):
    T, N, Fw = x.shape
    s = torch.tanh(mm(x.reshape(T * N, Fw), w["head.w"]) + w["head.b"])
    s = s.reshape(T, N, -1) * dims["scale"]
    nb = dims["n_base"]
    s = s.reshape(T, N, -1, nb)
    blank = s.new_full(s.shape[:-1] + (1,), dims["blank_score"])
    return torch.cat([blank, s], -1).reshape(T, N, -1)


def forward(w: dict, model: dict, signal: torch.Tensor,
            mm=f32_mm) -> torch.Tensor:
    """Signal [N, T_sig] f32 -> CRF scores [T, N, n_score] f32."""
    dims = model_dims(model)
    x = conv_stack(w, dims, signal.float())
    for i in range(dims["layers"]):
        x = lstm(x, w[f"rnn.{i}.w_ih"], w[f"rnn.{i}.w_hh"],
                 w[f"rnn.{i}.bias"], reverse=(i % 2 == 0), mm=mm)
    return crf_head(x, w, dims, mm=mm)
