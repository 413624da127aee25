"""The CRF head's f32 epilogue: the head's product and bias -> the scores.

``crf_head_chain`` is the plain version: the cast to f32, the bias add,
``tanh``, the scale and the blank column, as six PyTorch passes over the
scores.  ``crf_head_epilogue`` runs it for a tensor on the CPU and, for a
CUDA tensor, launches the hand-written kernel of ``csrc/crf_head.cu``,
which reads the product once and writes the scores once with the same
operations in the same order, so that its scores are bit-equal to the
chain's; it takes a bf16, f16 or f32 product and raises for anything else.
``_build.launches["crf_head_epilogue"]`` counts its kernel launches and
``launches["crf_head_epilogue.tiled"]`` those that took the kernel's tiled
path (whole 16-byte vectors in and out: every cell's head).  The kernel
replaces no Pallas kernel: the JAX package leaves this chain to XLA."""

from __future__ import annotations

import torch

from xna_basecaller_tpu_torch.ops import _build

# the kernel's dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def crf_head_chain(p: torch.Tensor, b: torch.Tensor, scale: float | None,
                   blank: float | None, n_base: int) -> torch.Tensor:
    """p [T, N, C] (any float dtype) and b [C] -> scores [T, N, C'] f32:
    tanh(p + b) * scale in f32, and with ``blank`` each group of ``n_base``
    columns led by a column of ``blank`` (C' = C (n_base + 1) / n_base)."""
    scores = torch.tanh(p.float() + b.float())
    if scale is not None:
        scores = scores * scale
    if blank is not None:
        T, N, C = scores.shape
        scores = scores.reshape(T, N, C // n_base, n_base)
        blanks = scores.new_full((T, N, C // n_base, 1), blank)
        scores = torch.cat([blanks, scores], -1).reshape(T, N, -1)
    return scores


def crf_head_epilogue(p: torch.Tensor, b: torch.Tensor, scale: float | None,
                      blank: float | None, n_base: int) -> torch.Tensor:
    """``crf_head_chain``'s scores in one pass: the chain for a CPU tensor,
    the kernel for a CUDA tensor (p bf16 or f16 and b of its dtype, or p
    f32 and b of any float dtype, which the chain too reads as f32)."""
    if p.device.type == "cpu":
        return crf_head_chain(p, b, scale, blank, n_base)
    if p.dtype == torch.float32 and b.is_floating_point():
        b = b.float()
    if p.dtype not in _DTYPES or b.dtype != p.dtype:
        raise ValueError(
            f"crf_head_epilogue: expected p [T, N, C] bf16, f16 or f32 and "
            f"b [C] of its dtype, got {p.dtype} {tuple(p.shape)} and "
            f"{b.dtype} {tuple(b.shape)}")
    p, b = p.contiguous(), b.contiguous()
    _build.check_tensor("crf_head_epilogue", "p", p, p.dtype,
                        (None, None, None))
    T, N, C = p.shape
    _build.check_tensor("crf_head_epilogue", "b", b, p.dtype, (C,))
    cols = C if blank is None else C // n_base * (n_base + 1)
    out = torch.empty(T, N, cols, device=p.device)
    if out.numel() == 0:
        return out
    _build.launch("crf_head_epilogue", "xna_crf_head_epilogue", p, b, out,
                  T * N, C, n_base, blank is not None,
                  0.0 if blank is None else blank,
                  1.0 if scale is None else scale, _DTYPES[p.dtype])
    return out
