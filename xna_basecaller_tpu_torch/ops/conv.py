"""1-D convolution stack of the signal encoder.

Port of ``xna_basecaller_tpu/ops/conv.py``: conv(1->4, k5) ->
conv(4->16, k5) -> conv(16->features, k19, stride) with padding ks // 2
and an activation after each.  The JAX package leaves the convolutions to
XLA; here they are ``torch.nn.functional.conv1d``.  Layout is PyTorch's:
activations [N, C, T], weights [out, in, k] (the JAX [k, in, out] weights
are transposed once, in ``utils/weights.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {
    "swish": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
    None: lambda x: x,
}


def conv_stack(insize: int, first: int, second: int, features: int,
               winlen: int, stride: int) -> nn.ModuleList:
    """The three convolutions, with uninitialised parameters."""
    shapes = [(insize, first, 5, 1), (first, second, 5, 1),
              (second, features, winlen, stride)]
    return nn.ModuleList(
        nn.Conv1d(i, o, k, stride=s, padding=k // 2, device="meta")
        .to_empty(device="cpu")
        for i, o, k, s in shapes)


def init_conv_(conv: nn.Conv1d, generator: torch.Generator) -> None:
    """torch's default Conv1d init (kaiming-uniform weight, uniform bias),
    drawn from ``generator``: the distributions of the JAX
    ``init_conv_params``."""
    out, insize, winlen = conv.weight.shape
    fan_in = insize * winlen
    with torch.no_grad():
        conv.weight.uniform_(-math.sqrt(6.0 / fan_in), math.sqrt(6.0 / fan_in),
                             generator=generator)
        conv.bias.uniform_(-1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in),
                           generator=generator)


def conv_stack_forward(layers: nn.ModuleList, x: torch.Tensor,
                       activation: str = "swish") -> torch.Tensor:
    """[N, insize, T] -> [N, features, T // stride]."""
    act = ACTIVATIONS[activation]
    for conv in layers:
        x = act(conv(x))
    return x
