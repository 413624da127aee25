"""The CRF head's f32 epilogue: the head's product and bias -> the scores.

``crf_head_chain`` is the plain version: the cast to f32, the bias add,
``tanh``, the scale and the blank column, as six PyTorch passes over the
scores.  ``crf_head_epilogue`` runs it for a tensor on the CPU and, for a
CUDA tensor, launches the hand-written kernel of ``csrc/crf_head.cu``,
which reads the product once and writes the scores once with the same
operations in the same order, so that its scores are bit-equal to the
chain's; it takes a bf16, f16 or f32 product and raises for anything else.
``crf_head_epilogue.launches`` counts its kernel launches and
``crf_head_epilogue.launches_tiled`` those that took the kernel's tiled
path (whole 16-byte vectors in and out: every cell's head).  The kernel
replaces no Pallas kernel: the JAX package leaves this chain to XLA."""

from __future__ import annotations

import ctypes
import functools

import torch

from xna_basecaller_tpu_torch.ops import _build

_MESSAGES = {-2: "shape not supported by the CRF head's kernel (rows, "
                 "columns and n_base >= 1; with a blank score, columns a "
                 "multiple of n_base; at most 2^31 - 1 blocks of 256 "
                 "units)"}


_P, _I = ctypes.c_void_p, ctypes.c_int
# the kernel's dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _entry():
    """(library, entry point), loaded and typed at the first call."""
    lib = _build.load("crf_head")
    fn = lib.xna_crf_head_epilogue
    fn.argtypes = [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, ctypes.c_float,
                   ctypes.c_float, _I, _P, ctypes.POINTER(_I)]
    fn.restype = _I
    return lib, fn


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
    if not p.is_cuda:
        raise ValueError(f"crf_head_epilogue: expected a CUDA tensor, got "
                         f"{p.device}")
    if p.dtype == torch.float32 and b.is_floating_point():
        b = b.float()
    if p.dtype not in _DTYPES or b.dtype != p.dtype or p.ndim != 3 \
            or b.shape != p.shape[2:]:
        raise ValueError(
            f"crf_head_epilogue: expected p [T, N, C] bf16, f16 or f32 and "
            f"b [C] of its dtype, got {p.dtype} {tuple(p.shape)} and "
            f"{b.dtype} {tuple(b.shape)}")
    _build.check_device("crf_head_epilogue", p)
    if b.device != p.device:
        raise ValueError(f"crf_head_epilogue: the bias is on {b.device}, "
                         f"the product on {p.device}")
    p, b = p.contiguous(), b.contiguous()
    T, N, C = p.shape
    cols = C if blank is None else C // n_base * (n_base + 1)
    out = torch.empty(T, N, cols, device=p.device)
    if out.numel() == 0:
        return out
    lib, fn = _entry()
    tiled = ctypes.c_int(0)
    rc = fn(p.data_ptr(), b.data_ptr(), out.data_ptr(), T * N, C, n_base,
            blank is not None, 0.0 if blank is None else blank,
            1.0 if scale is None else scale, _DTYPES[p.dtype],
            torch.cuda.current_stream().cuda_stream, ctypes.byref(tiled))
    _build.check(lib, rc, "crf head kernel", _MESSAGES)
    crf_head_epilogue.launches += 1
    crf_head_epilogue.launches_tiled += tiled.value
    return out


crf_head_epilogue.launches = 0
crf_head_epilogue.launches_tiled = 0
