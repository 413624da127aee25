"""Operations and bytes from shapes, and the card's peaks.

The peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity) at its full 700 W; a card set to a lower power limit reaches
less, so every share is reported with the limit beside it.

Counts follow the arithmetic of the port's kernel table: a matrix product
of [m, k] by [k, n] is 2 m k n operations; a recurrence of T steps over N
rows at width H is 2 T N H 4H (its product with W_hh, gates and cell
update not counted); each input byte is read once and each output byte
written once.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def frames(dims: dict, chunksize: int) -> int:
    """Frames a chunk gives after the strided convolution."""
    return chunksize // dims["stride"]


def conv_flops(dims: dict, chunksize: int) -> float:
    c_in, c1, c2, F = dims["conv"]
    T = frames(dims, chunksize)
    return (2.0 * chunksize * c1 * c_in * 5 + 2.0 * chunksize * c2 * c1 * 5
            + 2.0 * T * F * c2 * dims["winlen"])


def lstm_flops(dims: dict, chunksize: int) -> float:
    """Input projections and recurrences of all layers, one chunk."""
    F, T = dims["features"], frames(dims, chunksize)
    return dims["layers"] * 2 * (2.0 * T * F * 4 * F)


def head_flops(dims: dict, chunksize: int) -> float:
    return 2.0 * frames(dims, chunksize) * dims["features"] \
        * dims["head_cols"]


def forward_flops(dims: dict, chunksize: int) -> float:
    """Model operations of one chunk's forward: convolutions, input
    projections, recurrences and the CRF head's product."""
    return (conv_flops(dims, chunksize) + lstm_flops(dims, chunksize)
            + head_flops(dims, chunksize))


def bound_s(ops: float, bytes_moved: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(ops / peak_ops, bytes_moved / PEAK_BYTES)


def recurrence_ops(T: int, N: int, H: int) -> float:
    return 2.0 * T * N * H * 4 * H


def k1_bound_s(T: int, N: int, H: int, elem: int = 2) -> float:
    """K1 (inference recurrence): xp [T, N, 4H] in, ys [T, N, H] out,
    W_hh [H, 4H] once."""
    bytes_moved = elem * (T * N * 4 * H + T * N * H + H * 4 * H)
    return bound_s(recurrence_ops(T, N, H), bytes_moved, PEAK_BF16_FLOPS)


def k3a_bound_s(T: int, N: int, H: int, elem: int = 2) -> float:
    """K3a (training forward): K1's work, cell states written too."""
    bytes_moved = elem * (T * N * 4 * H + 2 * T * N * H + H * 4 * H)
    return bound_s(recurrence_ops(T, N, H), bytes_moved, PEAK_BF16_FLOPS)


def k3b_bound_s(T: int, N: int, H: int, elem: int = 2) -> float:
    """K3b (training backward of the recurrence): twice K3a's operations
    (the gates' recompute and the carry's product); dys, xp, ys and cs
    in, dxp out."""
    bytes_moved = elem * (2 * T * N * 4 * H + 3 * T * N * H + H * 4 * H)
    return bound_s(2 * recurrence_ops(T, N, H), bytes_moved,
                   PEAK_BF16_FLOPS)


BOUNDS = {"k1": k1_bound_s, "k3a": k3a_bound_s, "k3b": k3b_bound_s}
