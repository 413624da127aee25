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
batch of up to 384 rows is one launch.  K1 and K3a in f32 (duplex's transition
posteriors) keep each CTA's W_hh columns in registers, split by depth over
every lane, with the same ready flags.  K7 and K3b's f32 path keep a grid
barrier.  The reverse direction is read in reverse time inside the
kernels instead of flipping the tensors.

``LSTMRecurrence`` is the ``torch.autograd.Function`` of the trainable
recurrence (``lstm_recurrence_trainable``'s custom VJP): K3a forward, K3b
backward, then dW = sum_t h_p^T dgates as one ``torch.matmul``.

Each wrapper takes the plain version (``ops/lstm.py``) for a tensor on the
CPU, launches its kernel for a CUDA tensor, and raises for anything else;
``<wrapper>.launches`` counts its launches (one per group of batch rows;
K3b's group is one launch of its gate recompute and one of its recursion);
``lstm_recurrence.launches_f32`` counts K1's launches in f32 once more, and
``lstm_recurrence.launches_wide`` those on the 192-row tiles.
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

_MESSAGES = {
    -1: "the kernel's grid cannot be co-resident on this card",
    -2: "shape not supported by the kernel (H must be a multiple of 16, "
        "at most 1024 in f32 and in bf16 past 64 rows)",
    -3: "the kernel's shared-memory request was refused (H too large)",
}
_MESSAGES_INT8 = {**_MESSAGES, -2: "shape not supported by the kernel (H "
                                   "must be a multiple of 32)"}
_MESSAGES_BWD = {**_MESSAGES, -2: "shape not supported by the kernel (H must "
                                  "be a multiple of 16, of 32 in bf16)"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib(name: str, fn_name: str, argtypes):
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib, fn


def _call(lib, name: str, *ints: int) -> int:
    """The integer a library's size query returns for integer arguments."""
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = [_I] * len(ints), _I
    return fn(*ints)


def group_rows(source: str, dtype: torch.dtype) -> int:
    """Batch rows one launch of the recurrence of ``csrc/<source>.cu``
    (``lstm_recurrence``: K1 and K3a, 384 in bf16 and 256 in f32;
    ``lstm_int8``: K7, 256 in either) takes for xp of ``dtype``; the
    wrappers launch once per group of that many rows."""
    lib = _build.load(source)
    if source == "lstm_int8":
        return _call(lib, "xna_lstm_int8_group_rows")
    return _call(lib, "xna_lstm_group_rows", int(dtype == torch.bfloat16))


def bf16_geometry(rows: int, H: int) -> dict:
    """The geometry of a bf16 launch of K1 over 65-384 ``rows`` of width
    ``H`` on the current card: whether it takes the wide geometry, rows a
    tile, CTAs, columns a chunk of h, ring stages (for tests and tools;
    the launch itself reports whether it took the wide geometry)."""
    lib, fn = _lib("lstm_recurrence", "xna_lstm_bf16_geometry",
                   [_I, _I, _P])
    out = (ctypes.c_int * 5)()
    _build.check(lib, fn(rows, H, out), "lstm_recurrence geometry",
                 _MESSAGES)
    return dict(zip(("wide", "rows", "ctas", "chunk_cols", "stages"), out))


def _check(what: str, shapes: dict[str, tuple],
           fixed: dict[str, torch.dtype] | None = None, **tensors):
    """Raise unless every tensor is contiguous, on CUDA and of the shape
    given for it, those named in ``fixed`` of the dtype given there, and the
    others all of one dtype, f32 or bf16."""
    fixed = fixed or {}
    dtype = None
    for name, t in tensors.items():
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous CUDA "
                             f"tensor, got {t.device}")
        _build.check_device(f"{what}: {name}", t)
        if t.shape != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if name in fixed:
            if t.dtype != fixed[name]:
                raise ValueError(f"{what}: {name} must be {fixed[name]}, "
                                 f"got {t.dtype}")
            continue
        dtype = dtype or t.dtype
        if t.dtype != dtype or dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{what}: tensors must all be f32 or all bf16, "
                             f"{name} is {t.dtype}")


def _recurrence_shapes(what: str, xp: torch.Tensor, w_hh: torch.Tensor):
    if xp.ndim != 3 or w_hh.ndim != 2:
        raise ValueError(f"{what}: xp must be 3-d and w_hh 2-d")
    T, N, H4 = xp.shape
    H = H4 // 4
    return T, N, H, {"xp": (T, N, 4 * H), "w_hh": (H, 4 * H),
                     "ys": (T, N, H), "cs": (T, N, H), "dys": (T, N, H),
                     "w_q": (H, 4 * H), "scale": (4 * H,)}


def _recurrence(xp: torch.Tensor, w_hh: torch.Tensor, reverse: bool,
                cells: bool):
    """K1 (``cells`` False) or K3a: ys, and cs or None."""
    what = "lstm_forward_with_cells" if cells else "lstm_recurrence"
    T, N, H, shapes = _recurrence_shapes(what, xp, w_hh)
    _check(what, shapes, xp=xp, w_hh=w_hh)
    ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)
    cs = torch.empty_like(ys) if cells else None
    lib, fn = _lib("lstm_recurrence", "xna_lstm_recurrence",
                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                    _P])
    group = group_rows("lstm_recurrence", xp.dtype)
    wide = ctypes.c_int(0)
    size = xp.element_size()
    stream = torch.cuda.current_stream().cuda_stream
    for n0 in range(0, N, group):
        rows = min(group, N - n0)
        hbuf = torch.zeros(_call(lib, "xna_lstm_hbuf_elems", rows, H),
                           dtype=xp.dtype, device=xp.device)
        flags = torch.zeros(H, dtype=torch.int32, device=xp.device)
        rc = fn(xp.data_ptr() + n0 * 4 * H * size, w_hh.data_ptr(),
                ys.data_ptr() + n0 * H * size,
                cs.data_ptr() + n0 * H * size if cells else None,
                hbuf.data_ptr(), flags.data_ptr(), T, rows, N, H,
                int(reverse), int(xp.dtype == torch.bfloat16), stream,
                ctypes.byref(wide))
        _build.check(lib, rc, f"{what} kernel", _MESSAGES)
        if cells:
            lstm_forward_with_cells.launches += 1
        else:
            lstm_recurrence.launches += 1
            if xp.dtype == torch.float32:
                lstm_recurrence.launches_f32 += 1
            lstm_recurrence.launches_wide += wide.value
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
    T, N, H, shapes = _recurrence_shapes(what, xp, w_hh)
    _check(what, shapes, xp=xp, w_hh=w_hh, ys=ys, cs=cs, dys=dys)
    lib, fn = _lib("lstm_backward", "xna_lstm_backward",
                   [_P] * 9 + [_I] * 6 + [_P])
    group_rows = lib.xna_lstm_backward_group_rows
    group_rows.argtypes, group_rows.restype = [_I], _I
    is_bf16 = int(xp.dtype == torch.bfloat16)
    group = group_rows(is_bf16)
    dxp = torch.empty_like(xp)
    act = torch.empty(xp.shape, dtype=torch.float32, device=xp.device)
    size = xp.element_size()
    stream = torch.cuda.current_stream().cuda_stream
    for n0 in range(0, N, group):
        rows = min(group, N - n0)
        dgbuf = torch.empty(2, rows, 4 * H, dtype=xp.dtype, device=xp.device)
        flags = torch.zeros(H, dtype=torch.int32, device=xp.device)
        row4, row1 = n0 * 4 * H, n0 * H
        rc = fn(xp.data_ptr() + row4 * size, ys.data_ptr() + row1 * size,
                cs.data_ptr() + row1 * size, dys.data_ptr() + row1 * size,
                w_hh.data_ptr(), act.data_ptr() + row4 * 4,
                dxp.data_ptr() + row4 * size, dgbuf.data_ptr(),
                flags.data_ptr(), T, rows, N, H, int(reverse), is_bf16,
                stream)
        _build.check(lib, rc, "LSTM backward kernel", _MESSAGES_BWD)
        lstm_backward_dxp.launches += 1
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
    T, N, H, shapes = _recurrence_shapes(what, xp, w_q)
    _check(what, shapes, {"w_q": torch.int8, "scale": torch.float32},
           xp=xp, w_q=w_q, scale=scale)
    ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)
    lib, fn = _lib("lstm_int8", "xna_lstm_int8",
                   [_P] * 6 + [_I] * 6 + [_P])
    group = group_rows("lstm_int8", xp.dtype)
    size = xp.element_size()
    stream = torch.cuda.current_stream().cuda_stream
    for n0 in range(0, N, group):
        rows = min(group, N - n0)
        hbuf = torch.zeros(2, rows, H, dtype=torch.int8, device=xp.device)
        counter = torch.zeros(1, dtype=torch.int32, device=xp.device)
        rc = fn(xp.data_ptr() + n0 * 4 * H * size, w_q.data_ptr(),
                scale.data_ptr(), ys.data_ptr() + n0 * H * size,
                hbuf.data_ptr(), counter.data_ptr(), T, rows, N, H,
                int(reverse), int(xp.dtype == torch.bfloat16), stream)
        _build.check(lib, rc, f"{what} kernel", _MESSAGES_INT8)
        lstm_recurrence_int8.launches += 1
    return ys


lstm_recurrence.launches = 0
lstm_recurrence.launches_f32 = 0   # those of K1's f32 route, counted again
lstm_recurrence.launches_wide = 0  # those on the wide geometry, again
lstm_forward_with_cells.launches = 0
lstm_backward_dxp.launches = 0
lstm_recurrence_int8.launches = 0


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
