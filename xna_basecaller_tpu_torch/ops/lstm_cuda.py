"""The LSTM recurrence as hand-written CUDA kernels, their wrappers, and the
LSTM layers and stack that run them.

- K1, ``lstm_recurrence`` (``csrc/lstm_recurrence.cu``), replaces
  ``xna_basecaller_tpu/ops/lstm_pallas.py::lstm_recurrence_pallas``
  (``_make_scan_kernel``): the inference recurrence.
- K3a, ``lstm_forward_with_cells`` (the same source, under a template
  flag), replaces ``_pallas_fwd_with_cells`` (``_make_fwd_cells_kernel``):
  the trainable forward, which also writes the cell states.
- K3b, ``lstm_backward_dxp`` (``csrc/lstm_backward.cu``), replaces
  ``_pallas_bwd_dxp`` (``_make_bwd_kernel``): the analytic reverse
  recursion, which gives the gradient of xp.
- K7, ``lstm_recurrence_int8`` (``csrc/lstm_int8.cu``), replaces
  ``lstm_recurrence_pallas_int8`` (``_make_int8_kernel``): the inference
  recurrence of ``--quantize``, int8 W_hh and h on the int8 tensor cores.
  ``lstm_forward_int8`` and ``lstm_stack_forward_int8`` are the layer and
  the stack of that path (``lstm_forward_pallas_int8``,
  ``lstm_stack_forward_pallas_int8``): the input projection as an
  ``int8_matmul``, then K7.

Their bounds on the card and what their designs do about them are set out
at the top of the CUDA sources: one persistent launch per layer (per group
of batch rows), W_hh split across the blocks' shared memory, and the 720
dependent steps ordered by per-CTA ready flags in bf16 (each CTA waits
only for the producers of the h it reads): at up to 64 rows (K3a, K3b, K1
on the validation batch) clusters of CTAs split W_hh's depth; at more
than 64 (K1 at the basecall batch) each CTA brings the chunks of h by bulk
copies (TMA) into an mbarrier ring and multiplies them on wgmma in index
order, so that every call adds the gates' partial products in one order
and gives the same bits; its CTAs take 128-row tiles wherever that grid
fits the card, else 192-row tiles (257-384 rows at H=768), so that a bf16
batch of up to 384 rows is one launch; at H=1024 (up to 256 rows) the
CTAs come in clusters of 2 that split W_hh's depth, each bringing in
half of h, and add their partial gates through distributed shared
memory.  K1 and K3a in f32 (duplex's transition posteriors) keep each
CTA's W_hh columns in registers, split by depth over every lane, with the
same ready flags.  K7 and K3b's f32 path keep a grid
barrier.  The reverse direction is read in reverse time inside the
kernels instead of flipping the tensors.

``LSTMRecurrence`` is the ``torch.autograd.Function`` of the trainable
recurrence (``lstm_recurrence_trainable``'s custom VJP): K3a forward, K3b
backward, then dW = sum_t h_p^T dgates as one ``torch.matmul``.

Each wrapper takes the plain version (``ops/lstm.py``) for a tensor on the
CPU, launches its kernel for a CUDA tensor, and raises for anything else;
``_build.launches[<wrapper>]`` counts its launches (one per group of batch
rows; K3b's group is one launch of its gate recompute and one of its
recursion), ``launches["lstm_recurrence.f32"]`` K1's in f32 once more,
``launches["<wrapper>.wide"]`` those of K1 and K3a on the 192-row tiles
and ``launches["<wrapper>.split"]`` those on the clusters that split the
depth.
"""

from __future__ import annotations

import ctypes

import torch

from xna_basecaller_tpu_torch.ops import _build
from xna_basecaller_tpu_torch.ops.lstm import (
    input_projection, int8_matmul,
    lstm_backward_dxp as lstm_backward_dxp_plain,
    lstm_recurrence as lstm_recurrence_plain,
    lstm_recurrence_int8 as lstm_recurrence_int8_plain,
    lstm_recurrence_with_cells as lstm_recurrence_with_cells_plain,
    quantize_w_hh,
)


def group_rows(source: str, dtype: torch.dtype) -> int:
    """Batch rows one launch of the recurrence of ``csrc/<source>.cu``
    (``lstm_recurrence``: K1 and K3a, 384 in bf16 and 256 in f32;
    ``lstm_int8``: K7, 256 in either) takes for xp of ``dtype``; the
    wrappers launch once per group of that many rows."""
    if source == "lstm_int8":
        return _build.size("xna_lstm_int8_group_rows")
    return _build.size("xna_lstm_group_rows", int(dtype == torch.bfloat16))


BF16_GEOMETRIES = ("narrow", "wide", "split")


def bf16_geometry(rows: int, H: int) -> dict:
    """The geometry of a bf16 launch of K1 over 65-384 ``rows`` of width
    ``H`` on the current card (for tests and tools; the launch itself
    reports the one it took): ``geometry``, one of ``BF16_GEOMETRIES``
    (``narrow``: 128-row tiles; ``wide``: 192-row tiles; ``split``:
    128-row tiles, clusters of 2 CTAs that split W_hh's depth, each
    reading half of h), rows a tile, CTAs, columns a chunk of h, ring
    stages."""
    out = (ctypes.c_int * 5)()
    name = "xna_lstm_bf16_geometry"
    _build.check(name, _build.entry(name)(rows, H, out),
                 "lstm_recurrence geometry")
    return dict(zip(("geometry", "rows", "ctas", "chunk_cols", "stages"),
                    (BF16_GEOMETRIES[out[0]], *out[1:])))


def _dims(what: str, xp: torch.Tensor, w: torch.Tensor,
          w_dtype: torch.dtype | None = None, **others) -> tuple:
    """T, N, H of xp [T, N, 4H]; raise unless xp is f32 or bf16 (the LSTM
    kernels take all their tensors f32 or all bf16) and a contiguous CUDA
    tensor on the current device, as are w [H, 4H] (of ``w_dtype``, by
    default xp's) and each of ``others`` [T, N, H] of xp's dtype."""
    if xp.ndim != 3 or xp.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: xp must be [T, N, 4H], all tensors f32 "
                         f"or all bf16, got {xp.dtype} {list(xp.shape)}")
    T, N, H4 = xp.shape
    H = H4 // 4
    _build.check_tensor(what, "xp", xp, xp.dtype, (T, N, 4 * H))
    _build.check_tensor(what, "w", w, w_dtype or xp.dtype, (H, 4 * H))
    for name, t in others.items():
        _build.check_tensor(what, name, t, xp.dtype, (T, N, H))
    return T, N, H


def _row(t: torch.Tensor, n0: int) -> int:
    """The address of batch row n0 of the contiguous t [T, N, ...]."""
    return t.data_ptr() + n0 * t.stride(1) * t.element_size()


def _launch_groups(what: str, name: str, N: int, group: int, args,
                   also: str | None = None) -> None:
    """Launch the entry point ``name`` once per group of at most ``group``
    of the N batch rows (``also`` as ``_build.launch`` takes it):
    ``args(n0, rows)`` gives a launch's arguments up to the stream, the
    tensors' addresses at row n0 (``_row``) and its own scratch."""
    for n0 in range(0, N, group):
        _build.launch(what, name, *args(n0, min(group, N - n0)), also=also)


def _recurrence(xp: torch.Tensor, w_hh: torch.Tensor, reverse: bool,
                cells: bool):
    """K1 (``cells`` False) or K3a: ys, and cs or None."""
    what = "lstm_forward_with_cells" if cells else "lstm_recurrence"
    T, N, H = _dims(what, xp, w_hh)
    ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)
    cs = torch.empty_like(ys) if cells else None
    group = group_rows("lstm_recurrence", xp.dtype)

    def args(n0, rows):
        hbuf = torch.zeros(_build.size("xna_lstm_hbuf_elems", rows, H),
                           dtype=xp.dtype, device=xp.device)
        flags = torch.zeros(H, dtype=torch.int32, device=xp.device)
        return (_row(xp, n0), w_hh, _row(ys, n0),
                _row(cs, n0) if cells else None, hbuf, flags, T, rows, N, H,
                int(reverse), int(xp.dtype == torch.bfloat16))
    _launch_groups(what, "xna_lstm_recurrence", N, group, args,
                   "f32" if xp.dtype == torch.float32 and not cells else None)
    return ys, cs


def lstm_recurrence(xp: torch.Tensor, w_hh: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """K1: xp [T, N, 4H] (input projections + bias), w_hh [H, 4H], both f32
    or both bf16 -> ys [T, N, H] in that dtype.  On the card, one launch per
    group of at most 384 batch rows in bf16, 256 in f32 (rows are
    independent)."""
    if xp.device.type == "cpu":
        return lstm_recurrence_plain(xp, w_hh, reverse)
    return _recurrence(xp, w_hh, reverse, cells=False)[0]


def lstm_forward_with_cells(xp: torch.Tensor, w_hh: torch.Tensor,
                            reverse: bool = False):
    """K3a: as ``lstm_recurrence``, -> (ys, cs), the cell states [T, N, H]
    in xp's dtype."""
    if xp.device.type == "cpu":
        return lstm_recurrence_with_cells_plain(xp, w_hh, reverse)
    return _recurrence(xp, w_hh, reverse, cells=True)


def lstm_backward_dxp(dys: torch.Tensor, xp: torch.Tensor,
                      w_hh: torch.Tensor, ys: torch.Tensor, cs: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """K3b: the gradient of xp [T, N, 4H] from the gradient dys of ys and
    the forward's xp, w_hh, ys and cs, all of one dtype -> dxp in it.  On
    the card, one launch per group of at most 64 (bf16) or 256 (f32)
    batch rows."""
    if xp.device.type == "cpu":
        return lstm_backward_dxp_plain(dys, xp, w_hh, ys, cs, reverse)
    what = "lstm_backward_dxp"
    T, N, H = _dims(what, xp, w_hh, ys=ys, cs=cs, dys=dys)
    is_bf16 = int(xp.dtype == torch.bfloat16)
    dxp = torch.empty_like(xp)
    act = torch.empty(xp.shape, dtype=torch.float32, device=xp.device)

    def args(n0, rows):
        dgbuf = torch.empty(2, rows, 4 * H, dtype=xp.dtype, device=xp.device)
        flags = torch.zeros(H, dtype=torch.int32, device=xp.device)
        return (_row(xp, n0), _row(ys, n0), _row(cs, n0), _row(dys, n0),
                w_hh, _row(act, n0), _row(dxp, n0), dgbuf, flags, T, rows,
                N, H, int(reverse), is_bf16)
    _launch_groups(what, "xna_lstm_backward", N,
                   _build.size("xna_lstm_backward_group_rows", is_bf16), args)
    return dxp


def lstm_recurrence_int8(xp: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """K7: xp [T, N, 4H] f32 or bf16, w_q int8 [H, 4H], scale f32 [4H]
    (``quantize_w_hh``) -> ys [T, N, H] in xp's dtype.  On the card, one
    launch per group of at most 256 batch rows; H a multiple of 32."""
    if xp.device.type == "cpu":
        return lstm_recurrence_int8_plain(xp, w_q, scale, reverse)
    what = "lstm_recurrence_int8"
    T, N, H = _dims(what, xp, w_q, torch.int8)
    _build.check_tensor(what, "scale", scale, torch.float32, (4 * H,))
    ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)

    def args(n0, rows):
        hbuf = torch.zeros(2, rows, H, dtype=torch.int8, device=xp.device)
        counter = torch.zeros(1, dtype=torch.int32, device=xp.device)
        return (_row(xp, n0), w_q, scale, _row(ys, n0), hbuf, counter, T,
                rows, N, H, int(reverse), int(xp.dtype == torch.bfloat16))
    _launch_groups(what, "xna_lstm_int8", N,
                   group_rows("lstm_int8", xp.dtype), args)
    return ys


class LSTMRecurrence(torch.autograd.Function):
    """The trainable recurrence: xp [T, N, 4H], w_hh [H, 4H] -> ys.

    Forward K3a (saving xp, w_hh, ys and cs); backward K3b for dxp, then
    dW = sum_t h_p^T dgates as one matrix product over all steps, in the
    compute dtype with f32 accumulation, returned in w_hh's dtype
    (``lstm_pallas.py:550-572``).  Runs on the current stream."""

    @staticmethod
    def forward(ctx, xp, w_hh, reverse: bool):
        ys, cs = lstm_forward_with_cells(xp, w_hh, reverse)
        ctx.save_for_backward(xp, w_hh, ys, cs)
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dys):
        xp, w_hh, ys, cs = ctx.saved_tensors
        rev = ctx.reverse
        dxp = lstm_backward_dxp(dys.contiguous(), xp, w_hh, ys, cs, rev)
        H = w_hh.shape[0]
        # h_p of step t is ys[t-1] (ys[t+1] reversed); the first step's is 0
        h_p, dg = (ys[1:], dxp[:-1]) if rev else (ys[:-1], dxp[1:])
        dw = torch.matmul(h_p.reshape(-1, H).T, dg.reshape(-1, 4 * H))
        return dxp, dw.to(w_hh.dtype), None


def lstm_forward(params, x: torch.Tensor, reverse: bool = False):
    """One LSTM layer over x [T, N, in] -> [T, N, H]: the input projection
    as one matrix product, then the recurrence (K1 on the card)."""
    xp = input_projection(params, x)
    return lstm_recurrence(xp, params["w_hh"].to(x.dtype).contiguous(),
                           reverse)


def lstm_forward_trainable(params, x: torch.Tensor, reverse: bool = False):
    """The differentiable layer (``lstm_forward_pallas_trainable``): the
    input projection (``torch.addmm``, differentiated by autograd), then
    ``LSTMRecurrence`` (K3a forward, K3b backward on the card)."""
    xp = input_projection(params, x)
    return LSTMRecurrence.apply(xp, params["w_hh"].to(x.dtype).contiguous(),
                                reverse)


def lstm_stack_forward(layers, directions, x: torch.Tensor):
    """The alternating-direction stack (``lstm_pallas.py:184-187``)."""
    for params, rev in zip(layers, directions):
        x = lstm_forward(params, x, reverse=rev)
    return x


def lstm_forward_int8(params, x: torch.Tensor, reverse: bool = False):
    """One layer of the int8 path (``lstm_forward_pallas_int8``): the input
    projection as an ``int8_matmul`` of x and the quantized w_ih, plus the
    bias, in x's dtype; then K7 over the quantized w_hh.  The weights are
    quantized as given (in the compute dtype, as JAX casts them first).
    The projection is per row, so it is taken before the walk, which reads
    time in reverse for ``reverse``."""
    wp_q, wp_scale = quantize_w_hh(params["w_ih"])
    xp = (int8_matmul(x, wp_q, wp_scale) + params["bias"]).to(x.dtype)
    w_q, scale = quantize_w_hh(params["w_hh"])
    return lstm_recurrence_int8(xp, w_q, scale, reverse)


def lstm_stack_forward_int8(layers, directions, x: torch.Tensor):
    """The alternating-direction stack of the int8 path
    (``lstm_pallas.py:320-323``)."""
    for params, rev in zip(layers, directions):
        x = lstm_forward_int8(params, x, reverse=rev)
    return x
