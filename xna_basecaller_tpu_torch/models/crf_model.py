"""Flagship model: conv stack + alternating-direction LSTM stack + CRF head.

Port of ``xna_basecaller_tpu/models/crf_model.py`` as an ``nn.Module``:

  conv(1->4, k5) -> conv(4->16, k5) -> conv(16->768, k19, stride 5)  [N,C,T]
  -> 5 x LSTM(768), alternating direction, reverse first            [T,N,C]
  -> LinearCRFEncoder: tanh * scale, fixed blank-score expansion    [T,N,Cs]

``forward(signal, compute_dtype)`` returns f32 scores [T, N, C] in the JAX
layout.  The conv stack runs in f32 (TF32 off, see ``pin_f32_precision``);
the LSTMs and the head run in ``compute_dtype`` (bf16 by default), with
the recurrence in the CUDA kernel K1 on the card (``ops/lstm_cuda.py``);
the decode and the loss always run in f32.  ``lstm_int8=True`` is the
``--quantize`` path: int8 input projections and head (``int8_matmul``) and
the int8 recurrence K7; an int8 signal (``round(sig * QUANT_SCALE)``, as
the basecaller uploads it with ``quantize``) is dequantized first.
``inference=False`` is the training forward: the differentiable
recurrence (K3a forward, K3b backward) and, given a ``torch.Generator``,
dropout.  The parameters stay f32 and are cast to the compute dtype on
the way in, so their gradients come back in f32.  Weights keep the JAX layout (``w_ih [in,4H]``, ``w_hh
[H,4H]``, head ``w [F, C']``) except the convolutions'.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from xna_basecaller_tpu_torch.core.config import ModelConfig
from xna_basecaller_tpu_torch.ops import crf as crf_ops
from xna_basecaller_tpu_torch.ops.conv import (
    conv_stack, conv_stack_forward, init_conv_,
)
from xna_basecaller_tpu_torch.ops.crf_head import (
    crf_head_chain, crf_head_epilogue,
)
from xna_basecaller_tpu_torch.ops.lstm import (
    init_lstm_params, int8_matmul, quantize_w_hh,
)
from xna_basecaller_tpu_torch.ops.lstm_cuda import (
    lstm_forward_trainable, lstm_stack_forward, lstm_stack_forward_int8,
)
from xna_basecaller_tpu_torch.utils.device import resolve_device

# int8 step of the quantized upload (``crf_model.py:32-35`` in JAX): the
# normalised signal spans +-5.3 sigma at a step of 1/24
QUANT_SCALE = 24.0


def pin_f32_precision() -> None:
    """f32 convolutions and matrix products in full f32: cuDNN would
    otherwise run f32 convolutions in TF32 (PyTorch's default), which keeps
    about three decimal digits."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class LSTMLayer(nn.Module):
    """One LSTM layer's parameters in the JAX layout (no bias_hh)."""

    def __init__(self, insize: int, size: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(insize, 4 * size))
        self.w_hh = nn.Parameter(torch.empty(size, 4 * size))
        self.bias = nn.Parameter(torch.empty(4 * size))

    def params(self, dtype) -> dict[str, torch.Tensor]:
        return {"w_ih": self.w_ih.to(dtype), "w_hh": self.w_hh.to(dtype),
                "bias": self.bias.to(dtype)}


class Linear(nn.Module):
    """x @ w + b with w [in, out], as the JAX ``init_linear`` lays it out."""

    def __init__(self, insize: int, size: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(insize, size))
        self.b = nn.Parameter(torch.empty(size))


def crf_head_forward(head: Linear, head_ext: Linear | None, x: torch.Tensor,
                     cfg: ModelConfig, int8: bool = False) -> torch.Tensor:
    """LinearCRFEncoder: x [T, N, F] -> scores [T, N, n_score] in f32.

    The products run in x's dtype; tanh, the scale and the blank expansion
    run in f32 on the product plus the bias (in x's dtype): in one kernel
    (``ops/crf_head.py::crf_head_epilogue``) where autograd does not need
    the chain, else as the chain of PyTorch passes (``crf_head_chain``: the
    training forward).
    ``int8=True`` (the ``--quantize`` path, ``crf_model.py:87-101`` in JAX)
    runs each product as an ``int8_matmul`` of x and the weight quantized
    per column (f32 out; the extra linear's is cast back to x's dtype
    before its bias)."""
    enc = cfg.encoder
    if int8:
        def dense(v, lin):
            return int8_matmul(v, *quantize_w_hh(lin.w.to(x.dtype)))
    else:
        def dense(v, lin):
            return v @ lin.w.to(x.dtype)
    if head_ext is not None:
        x = dense(x, head_ext).to(x.dtype) + head_ext.b.to(x.dtype)
    p, b = dense(x, head), head.b.to(x.dtype)
    grad = torch.is_grad_enabled() and (p.requires_grad or b.requires_grad)
    epilogue = crf_head_chain if grad else crf_head_epilogue
    return epilogue(p, b, enc.scale, enc.blank_score, cfg.n_base)


def apply_dropout(x: torch.Tensor, rate: float,
                  generator: torch.Generator | None) -> torch.Tensor:
    """Keep each element with probability 1 - rate, scaled by 1/(1 - rate)
    (``crf_model.py:139-143`` in JAX); the identity without a generator or
    at rate 0."""
    if generator is None or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class Model(nn.Module):
    """The flagship CRF model.  ``seed`` draws random weights from a
    ``torch.Generator`` (the JAX init's distributions); ``seed=None``
    leaves them uninitialised for ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 device: str | torch.device = "cuda", seed: int | None = 0):
        super().__init__()
        if cfg.is_ctc:
            raise ValueError("a [[block]] config is the CTC (QuartzNet) "
                             "family: models/ctc_model.py::CtcModel")
        dev = resolve_device(device)
        enc = cfg.encoder
        self.cfg = cfg
        self.seqdist = crf_ops.CTCCRF(cfg.state_len, cfg.alphabet)
        self.conv = conv_stack(cfg.input_features, enc.first_conv_size,
                               enc.second_conv_size, enc.features,
                               enc.winlen, enc.stride)
        self.rnn = nn.ModuleList(
            LSTMLayer(enc.features, enc.features)
            for _ in range(enc.num_rnn_layers))
        self.directions = tuple(i % 2 == 0
                                for i in range(enc.num_rnn_layers))
        head_size = ((cfg.n_base + 1) * cfg.n_state
                     if enc.blank_score is None
                     else cfg.n_base ** (cfg.state_len + 1))
        self.head = Linear(enc.features, head_size)
        self.head_ext = (Linear(enc.features, enc.features)
                         if enc.extra_linear else None)
        if seed is not None:
            self.reset_parameters(seed)
        self.to(dev)
        pin_f32_precision()

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        for conv in self.conv:
            init_conv_(conv, g)
        for layer in self.rnn:
            H = layer.w_hh.shape[0]
            p = init_lstm_params(layer.w_ih.shape[0], H, g)
            for k, v in p.items():
                getattr(layer, k).copy_(v)
        for lin in (self.head, self.head_ext):
            if lin is None:
                continue
            insize = lin.w.shape[0]
            lin.w.uniform_(-math.sqrt(6.0 / insize), math.sqrt(6.0 / insize),
                           generator=g)
            lin.b.uniform_(-1.0 / math.sqrt(insize), 1.0 / math.sqrt(insize),
                           generator=g)

    @property
    def stride(self) -> int:
        return self.cfg.encoder.stride

    def forward(self, signal: torch.Tensor, compute_dtype=torch.bfloat16,
                inference: bool = True,
                dropout: torch.Generator | None = None,
                lstm_int8: bool = False) -> torch.Tensor:
        """Raw signal [N, T_sig] (or [N, T_sig, 1]), any float dtype or the
        int8 codes of the quantized upload -> CRF scores [T, N, n_score] in
        f32.

        ``inference=False`` runs the trainable recurrence; ``dropout``, a
        generator on the model's device, then drops ``drop_rate_bottom``
        after the conv stack and after each LSTM but the last, and
        ``drop_rate`` before the head (``crf_model.py:139-146, 154,
        183-185`` in JAX).  ``lstm_int8`` with ``inference`` runs the int8
        stack (K7) and the int8 head, as JAX's TPU path does; JAX's CPU path
        keeps the float scan there (``crf_model.py:158``), while the port's
        CPU path runs K7's plain version."""
        enc = self.cfg.encoder
        if signal.dtype == torch.int8:
            # the reciprocal's multiply, not a division, as JAX computes it
            signal = signal.float() * (1.0 / QUANT_SCALE)
        if signal.ndim == 3:
            signal = signal[..., 0]
        x = conv_stack_forward(self.conv, signal.float()[:, None, :],
                               enc.activation)
        x = apply_dropout(x, enc.drop_rate_bottom, dropout)
        x = x.permute(2, 0, 1).to(compute_dtype).contiguous()   # [T, N, C]
        layers = [layer.params(compute_dtype) for layer in self.rnn]
        if inference:
            stack = lstm_stack_forward_int8 if lstm_int8 \
                else lstm_stack_forward
            x = stack(layers, self.directions, x)
        else:
            for i, (params, rev) in enumerate(zip(layers, self.directions)):
                x = lstm_forward_trainable(params, x, reverse=rev)
                if i < len(layers) - 1:   # the last one's sits in the head
                    x = apply_dropout(x, enc.drop_rate_bottom, dropout)
        x = apply_dropout(x, enc.drop_rate, dropout)
        return crf_head_forward(self.head, self.head_ext, x, self.cfg,
                                int8=lstm_int8 and inference)

    def loss(self, scores, targets, lengths, **kw):
        return self.seqdist.ctc_loss(scores, targets, lengths, **kw)

    def decode_batch(self, scores) -> list[str]:
        return self.seqdist.decode_batch(scores)
