"""Legacy CTC model family: QuartzNet-style TCS-conv encoder + CTC head.

Port of ``xna_basecaller_tpu/models/ctc_model.py`` as an ``nn.Module``:
config-driven blocks of time-channel-separable convolutions (depthwise
then pointwise, or one plain convolution) with batchnorm, residual
branches and dropout, a 1x1-conv decoder and ``log_softmax``, giving
log-probs [T, N, C] in f32, and the CTC + label-smoothing loss.  The
convolutions run through cuDNN on the card (TF32 off); the family runs in
f32, as the JAX package runs it.

Activations are [N, C, T] (PyTorch's convolution layout).  Parameter and
buffer names follow the JAX parameter tree, so that a state_dict key is
the JAX checkpoint key with '.' for '/' (``blocks.0.convs.1.tcs.depthwise.w``
is ``blocks/0/convs/1/tcs/depthwise/w``); convolution weights are
[out, in/groups, k] here and [k, in/groups, out] there
(``utils/weights.py`` swaps them).

BatchNorm is written by hand, not ``nn.BatchNorm1d``: the JAX layer keeps
the *biased* batch variance in its running stats, with momentum 0.1 and
eps 1e-3 (torch's module stores the unbiased variance, eps 1e-5).  Its
running mean and variance are buffers: the training forward returns the
updated stats and ``train_step`` writes them after the optimizer update
(``merge_bn_stats``), so no gradient and no weight decay reaches them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xna_basecaller_tpu_torch.core.config import BlockConfig, ModelConfig
from xna_basecaller_tpu_torch.models.crf_model import (
    apply_dropout, pin_f32_precision,
)
from xna_basecaller_tpu_torch.ops import ctc as ctc_ops
from xna_basecaller_tpu_torch.ops.conv import ACTIVATIONS
from xna_basecaller_tpu_torch.utils.device import resolve_device
from xna_basecaller_tpu_torch.utils.trace import span

BN_EPS = 1e-3
BN_MOMENTUM = 0.1


class Conv(nn.Module):
    """A 1-D convolution's weight [out, in/groups, k] (and bias)."""

    def __init__(self, insize: int, size: int, winlen: int, groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.groups = groups
        self.w = nn.Parameter(torch.empty(size, insize // groups, winlen))
        self.b = nn.Parameter(torch.empty(size)) if bias else None

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        """The JAX ``_init_conv`` distributions: weight uniform in
        +-sqrt(6 / fan_in), bias in +-1 / sqrt(fan_in)."""
        _, cin, winlen = self.w.shape
        fan_in = cin * winlen
        bound = math.sqrt(6.0 / fan_in)
        self.w.uniform_(-bound, bound, generator=g)
        if self.b is not None:
            bb = 1.0 / math.sqrt(fan_in)
            self.b.uniform_(-bb, bb, generator=g)

    def forward(self, x, stride: int = 1, padding: int = 0,
                dilation: int = 1):
        return F.conv1d(x, self.w, self.b, stride=stride, padding=padding,
                        dilation=dilation, groups=self.groups)


class TCS(nn.Module):
    """Time-channel-separable convolution (depthwise, then pointwise), or
    one plain convolution."""

    def __init__(self, insize: int, size: int, kernel: int,
                 separable: bool):
        super().__init__()
        if separable:
            self.depthwise = Conv(insize, insize, kernel, groups=insize)
            self.pointwise = Conv(insize, size, 1)
        else:
            self.conv = Conv(insize, size, kernel)
        self.separable = separable

    def forward(self, x, stride: int, dilation: int, padding: int):
        if self.separable:
            y = self.depthwise(x, stride, padding, dilation)
            return self.pointwise(y)
        return self.conv(x, stride, padding, dilation)


class BatchNorm(nn.Module):
    """JAX's ``_bn_forward``: scale, bias (parameters), running mean and
    biased variance (buffers)."""

    def __init__(self, size: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.register_buffer("mean", torch.zeros(size))
        self.register_buffer("var", torch.ones(size))

    def forward(self, x: torch.Tensor, train: bool):
        """x [N, C, T] -> (y, new stats (mean, var) or None).  Training
        normalises by the batch statistics over (N, T)."""
        if train:
            mean = x.mean(dim=(0, 2))
            var = (x - mean[:, None]).square().mean(dim=(0, 2))
            new = ((1 - BN_MOMENTUM) * self.mean
                   + BN_MOMENTUM * mean.detach(),
                   (1 - BN_MOMENTUM) * self.var
                   + BN_MOMENTUM * var.detach())
        else:
            mean, var = self.mean, self.var
            new = None
        scale = self.scale * torch.rsqrt(var + BN_EPS)
        y = (x - mean[:, None]) * scale[:, None] + self.bias[:, None]
        return y, new


class ConvBN(nn.Module):
    def __init__(self, insize: int, size: int, kernel: int,
                 separable: bool):
        super().__init__()
        self.tcs = TCS(insize, size, kernel, separable)
        self.bn = BatchNorm(size)


class Block(nn.Module):
    """One QuartzNet block: ``repeat`` TCS convolutions with batchnorm,
    and the residual branch (a 1x1 convolution with batchnorm)."""

    def __init__(self, insize: int, blk: BlockConfig):
        super().__init__()
        self.cfg = blk
        self.convs = nn.ModuleList(
            ConvBN(insize if i == 0 else blk.filters, blk.filters,
                   blk.kernel[0], blk.separable)
            for i in range(blk.repeat))
        self.residual = (ConvBN(insize, blk.filters, 1, False)
                         if blk.residual else None)

    def forward(self, x, act, train: bool, dropout, stats: list):
        """JAX's ``_block_forward``: per conv, TCS then batchnorm, then
        activation and dropout except after the last, whose activation
        comes after the residual sum."""
        blk = self.cfg
        pad = (blk.kernel[0] // 2) * blk.dilation[0]
        y = x
        for i, conv in enumerate(self.convs):
            y = conv.tcs(y, blk.stride[0], blk.dilation[0], pad)
            y, ns = conv.bn(y, train)
            stats.append((conv.bn, ns))
            if i < blk.repeat - 1:
                y = dropout(act(y))
        if self.residual is not None:
            r = self.residual.tcs(x, 1, 1, 0)
            r, ns = self.residual.bn(r, train)
            stats.append((self.residual.bn, ns))
            y = y + r
        return dropout(act(y))


class CtcModel(nn.Module):
    """The QuartzNet CTC model of a ``[[block]]`` config.  ``seed`` draws
    random weights from a ``torch.Generator`` (the JAX init's
    distributions); ``seed=None`` leaves them uninitialised for
    ``load_state_dict``."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        blocks = []
        insize = cfg.input_features
        for blk in cfg.blocks:
            blocks.append(Block(insize, blk))
            insize = blk.filters
        self.blocks = nn.ModuleList(blocks)
        self.decoder = Conv(insize, len(cfg.labels), 1, bias=True)
        if seed is not None:
            self.reset_parameters(seed)
        self.to(dev)
        pin_f32_precision()

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(g)

    @property
    def stride(self) -> int:
        s = 1
        for blk in self.cfg.blocks:
            s *= blk.stride[0]
        return s

    @property
    def alphabet(self) -> str:
        return self.cfg.alphabet

    def forward(self, signal: torch.Tensor, train: bool = False,
                dropout: torch.Generator | None = None):
        """Raw signal [N, T_sig] (or [N, T_sig, 1]) -> log-probs [T, N, C]
        in f32.  ``train=True`` normalises by batch statistics and returns
        (log_probs, stats), stats a list of (batchnorm, (new mean, new
        var)) for ``merge_bn_stats``; ``dropout``, a generator on the
        model's device, drops each block's ``dropout`` rate."""
        if signal.ndim == 3:
            signal = signal[..., 0]
        act = ACTIVATIONS[self.cfg.encoder.activation]
        x = signal.float()[:, None, :]
        stats: list = []
        for block in self.blocks:
            rate = block.cfg.dropout

            def drop(y, rate=rate):
                return apply_dropout(y, rate, dropout)
            x = block(x, act, train, drop, stats)
        logits = self.decoder(x)                       # [N, C, T]
        log_probs = torch.log_softmax(logits.permute(2, 0, 1), dim=-1)
        return (log_probs, stats) if train else log_probs

    def decode_batch(self, log_probs) -> list[str]:
        """Greedy decode of a [T, N, C] batch on its device, collapse on
        the host."""
        paths, _ = ctc_ops.greedy_paths(log_probs)
        return [ctc_ops.collapse_path(p, alphabet=self.alphabet)[0]
                for p in paths.cpu().numpy()]

    def decode(self, log_probs_single, beamsize: int = 5,
               threshold: float = 1e-3, qscores: bool = False,
               return_path: bool = False):
        """Reference Model.decode contract (ctc/model.py:39-46) over one
        read's [T', C] log-probs."""
        if isinstance(log_probs_single, torch.Tensor):
            log_probs_single = log_probs_single.detach().cpu().numpy()
        lp = np.asarray(log_probs_single, np.float32)
        if beamsize == 1 or qscores:
            path, prob = lp.argmax(axis=1), np.exp(lp.max(axis=1))
            seq, qstring, moves = ctc_ops.collapse_path(
                path, prob, self.alphabet,
                qscale=self.cfg.qscore.scale, qbias=self.cfg.qscore.bias)
            out_seq = seq + qstring if qscores else seq
            if return_path:
                return out_seq, np.where(moves)[0]
            return out_seq
        seq, path = ctc_ops.beam_search(
            np.exp(lp), self.alphabet, beamsize, threshold)
        if return_path:
            return seq, path
        return seq

    def loss(self, log_probs, targets, lengths, reduction: str = "mean"):
        """The CTC + label-smoothing loss (``ctc_label_smoothing_loss``);
        ``reduction="none"`` gives each row's nll / length plus its share
        of the smoothing term, whose mean is the loss."""
        if reduction != "none":
            return ctc_ops.ctc_label_smoothing_loss(
                log_probs, targets, lengths)["loss"]
        w = ctc_ops.smoothing_weights(log_probs.shape[2], log_probs)
        nll = ctc_ops.ctc_loss(log_probs, targets, lengths, reduction="none")
        per = nll / lengths.to(nll.dtype).clamp(min=1.0)
        return per - (log_probs * w).mean(dim=(0, 2))

    def n_params(self) -> int:
        return sum(p.numel() for p in self.state_dict().values())


@torch.no_grad()
def merge_bn_stats(stats) -> None:
    """Write the training forward's running stats into the buffers."""
    for bn, new in stats:
        if new is not None:
            bn.mean.copy_(new[0])
            bn.var.copy_(new[1])


def masked_ctc_loss(log_probs, targets, lengths):
    """JAX's ``train_step`` loss: nll / max(length, 1) per row, the rows
    with ``length == 0`` (mesh padding) masked out, the mean over the valid
    rows, plus the label-smoothing term.  A masked row's first target is
    set to a label, so that its loss is finite before the mask (torch's
    loss of an empty or blank target may be inf, and inf x 0 is nan)."""
    valid = lengths > 0
    col0 = torch.arange(targets.shape[1], device=targets.device) == 0
    targets = torch.where(~valid[:, None] & col0, 1, targets)
    nll = -ctc_ops.ctc_loss_logz(log_probs, targets, lengths.clamp(min=1))
    per = nll / lengths.to(nll.dtype).clamp(min=1.0)
    validf = valid.to(nll.dtype)
    ctc = (per * validf).sum() / validf.sum().clamp(min=1.0)
    w = ctc_ops.smoothing_weights(log_probs.shape[2], log_probs)
    return ctc - (log_probs * w).mean()


def train_step(model: CtcModel, optimizer, chunks: torch.Tensor,
               targets: torch.Tensor, lengths: torch.Tensor,
               dropout: torch.Generator | None = None):
    """One CTC optimisation step (forward in training mode, the masked CTC
    + label-smoothing loss, backward, the optimizer's clip and AdamW, then
    the batchnorm running stats written); returns (loss, grad_norm) as 0-d
    f32 tensors.  ``optimizer`` is ``train/loop.py::Optimizer``.  The
    spans are ``train/loop.py::train_step``'s."""
    from xna_basecaller_tpu_torch.train.loop import global_norm

    with span("train.step"):
        for p in model.parameters():
            p.grad = None
        with span("train.forward"):
            log_probs, stats = model(chunks, train=True, dropout=dropout)
        with span("train.loss"):
            loss = masked_ctc_loss(log_probs, targets, lengths)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            grad_norm = global_norm([p.grad if p.grad is not None
                                     else torch.zeros_like(p)
                                     for p in model.parameters()])
            optimizer.step()
        merge_bn_stats(stats)
    return loss.detach(), grad_norm


def quartznet5x5_config(labels: str = "NACGT") -> ModelConfig:
    """The QuartzNet 5x5 shape the reference CTC family trains
    (https://arxiv.org/pdf/1910.10261.pdf; reference ctc/model.py:56-84
    builds it from [[block]] config sections)."""
    blocks = (
        BlockConfig(filters=256, repeat=1, kernel=(33,), stride=(3,),
                    separable=False),                        # C1
        BlockConfig(filters=256, repeat=5, kernel=(33,), residual=True,
                    separable=True, dropout=0.05),
        BlockConfig(filters=256, repeat=5, kernel=(39,), residual=True,
                    separable=True, dropout=0.05),
        BlockConfig(filters=512, repeat=5, kernel=(51,), residual=True,
                    separable=True, dropout=0.05),
        BlockConfig(filters=512, repeat=5, kernel=(63,), residual=True,
                    separable=True, dropout=0.05),
        BlockConfig(filters=512, repeat=5, kernel=(75,), residual=True,
                    separable=True, dropout=0.05),
        BlockConfig(filters=512, repeat=1, kernel=(87,),
                    separable=True),                         # C2
        BlockConfig(filters=1024, repeat=1, kernel=(1,),
                    separable=False),                        # C3
    )
    return ModelConfig(labels=tuple(labels), blocks=blocks,
                       package="xna_basecaller_tpu.models.ctc_model")
