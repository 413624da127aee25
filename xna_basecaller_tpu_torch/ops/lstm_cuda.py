"""K1: the LSTM recurrence as a hand-written CUDA kernel
(``csrc/lstm_recurrence.cu``), its wrapper, and the LSTM layer and stack
that run it.

K1 replaces ``xna_basecaller_tpu/ops/lstm_pallas.py::lstm_recurrence_pallas``
(``_make_scan_kernel``).  Its bound on the card and what its design does
about it are set out at the top of the CUDA source: one persistent
cooperative launch per layer (per 256 batch rows), W_hh split across the
blocks' shared memory, a grid barrier between the 720 dependent steps.
The reverse direction is read in reverse time inside the kernel instead
of flipping xp and ys.

``lstm_recurrence`` takes the plain version (``ops/lstm.py``) for a tensor
on the CPU, launches the kernel for a CUDA tensor, and raises for anything
else; ``lstm_recurrence.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from xna_basecaller_tpu_torch.ops import _build
from xna_basecaller_tpu_torch.ops.lstm import (
    input_projection, lstm_recurrence as lstm_recurrence_plain,
)

_MESSAGES = {
    -1: "the kernel's grid cannot be co-resident on this card",
    -2: "shape not supported by the kernel (H must be a multiple of 16)",
    -3: "the kernel's shared-memory request was refused (H too large)",
}


def _fn():
    lib = _build.load("lstm_recurrence")
    fn = lib.xna_lstm_recurrence
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    group_rows = lib.xna_lstm_group_rows
    group_rows.argtypes, group_rows.restype = [], ctypes.c_int
    return lib, fn, group_rows()


def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """xp [T, N, 4H] (input projections + bias), w_hh [H, 4H], both f32 or
    both bf16 -> ys [T, N, H] in that dtype.  On the card, one launch per
    group of at most 256 batch rows (rows are independent)."""
    if xp.device.type == "cpu":
        return lstm_recurrence_plain(xp, w_hh, reverse)
    for name, t, ndim in (("xp", xp, 3), ("w_hh", w_hh, 2)):
        if not t.is_cuda or t.ndim != ndim or not t.is_contiguous():
            raise ValueError(f"lstm_recurrence: {name} must be a contiguous "
                             f"{ndim}-d CUDA tensor")
    if xp.dtype not in (torch.float32, torch.bfloat16) \
            or w_hh.dtype != xp.dtype:
        raise ValueError("lstm_recurrence: xp and w_hh must both be f32 or "
                         f"both bf16, got {xp.dtype} and {w_hh.dtype}")
    T, N, H4 = xp.shape
    H = H4 // 4
    if w_hh.shape != (H, H4):
        raise ValueError(f"lstm_recurrence: w_hh {tuple(w_hh.shape)} does "
                         f"not match xp {tuple(xp.shape)}")
    ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)
    lib, fn, group = _fn()
    size = xp.element_size()
    stream = torch.cuda.current_stream().cuda_stream
    for n0 in range(0, N, group):
        rows = min(group, N - n0)
        hbuf = torch.zeros(2, rows, H, dtype=xp.dtype, device=xp.device)
        counter = torch.zeros(1, dtype=torch.int32, device=xp.device)
        rc = fn(xp.data_ptr() + n0 * H4 * size, w_hh.data_ptr(),
                ys.data_ptr() + n0 * H * size, hbuf.data_ptr(),
                counter.data_ptr(), T, rows, N, H, int(reverse),
                int(xp.dtype == torch.bfloat16), stream)
        _build.check(lib, rc, "LSTM recurrence kernel", _MESSAGES)
        lstm_recurrence.launches += 1
    return ys


lstm_recurrence.launches = 0


def lstm_forward(params, x: torch.Tensor, reverse: bool = False):
    """One LSTM layer over x [T, N, in] -> [T, N, H]: the input projection
    as one matrix product, then the recurrence (K1 on the card)."""
    xp = input_projection(params, x)
    return lstm_recurrence(xp, params["w_hh"].to(x.dtype).contiguous(),
                           reverse)


def lstm_stack_forward(layers, directions, x: torch.Tensor):
    """The alternating-direction stack (``lstm_pallas.py:184-187``)."""
    for params, rev in zip(layers, directions):
        x = lstm_forward(params, x, reverse=rev)
    return x
