"""The CRF's hand-written CUDA kernels, with their wrappers.

K2a, K2b, K2c (``csrc/crf_decode.cu``): the Viterbi decode, replacing the
three Pallas kernels of
``xna_basecaller_tpu/ops/crf_pallas.py::decode_paths_pallas``
(``_bwd_kernel_unrolled``, ``_fwd_viterbi_kernel``, ``_traceback_kernel``).

K4, K5a, K5b, K6a, K6b: the training loss, replacing the Pallas kernels
that the JAX package's default loss runs: the forward scan K4
(``forward_scan``, ``csrc/crf_loss.cu``, for ``_fwd_kernel``), the backward
scan K5a (``backward_scan``, which is K2a's kernel, for ``_bwd_kernel``),
the edge posteriors K5b (``edge_posteriors``, for ``_post_kernel``), and the
stay/move lattice's forward K6a (``lattice_forward``, for
``_lat_fwd_kernel``) and backward K6b (``lattice_backward``, for
``_lat_bwd_kernel`` with the combine fused in).

Their bound on the card, and what the design does about it, is set out at
the top of each CUDA source: the scans are bound by reading their inputs
once and by their 720 dependent steps; one block per sequence keeps the
recurrent vector in shared memory; K2a/K5a and K4 read each step's row
from a ring of rows that bulk copies keep in flight into shared memory
(``csrc/crf_ring.cuh``), the others read it coalesced, prefetching the
next one.

Each wrapper takes the plain version in ``ops/crf.py`` for a tensor on the
CPU, launches its kernel for a CUDA tensor, and raises for anything else;
``<wrapper>.launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from xna_basecaller_tpu_torch.ops import _build
from xna_basecaller_tpu_torch.ops import crf

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> (source, argument types)
_SIGNATURES = {
    "xna_crf_backward": ("crf_decode", [_P, _P, _I, _I, _I, _I, _P]),
    "xna_crf_fwd_viterbi": ("crf_decode",
                            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "xna_crf_traceback": ("crf_decode", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "xna_crf_forward": ("crf_loss", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "xna_crf_posteriors": ("crf_loss",
                           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "xna_lattice_forward": ("crf_loss", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "xna_lattice_backward": ("crf_loss",
                             [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
}
_MESSAGES = {-2: "shape not supported by the kernel (n_state <= 256, "
                 "n_base + 1 <= 8, n_state * (n_base + 1) <= 2048)"}
_SCAN_MESSAGES = {**_MESSAGES, -3: "scores not 8-byte aligned"}
_LATTICE_MESSAGES = {-2: "lattice not supported by the kernel (1 <= n <= "
                         "6144 positions)"}


def _fn(name: str):
    source, argtypes = _SIGNATURES[name]
    lib = _build.load(source)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _check(t: torch.Tensor, name: str, dtype, ndim: int):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ring_aligned(scores: torch.Tensor) -> torch.Tensor:
    """``scores`` as the ring of K2a/K5a and K4 takes them: starting 8-byte
    aligned, so that every row is (``csrc/crf_ring.cuh``); a view that
    starts at an odd float is copied."""
    return scores if scores.data_ptr() % 8 == 0 else scores.clone()


def backward_scan(scores: torch.Tensor, n_base: int, state_len: int):
    """K2a, and K5a on the loss's backward: scores [T, N, C] f32 -> betas
    [T+1, N, n_state] (beta_T = 0)."""
    if scores.device.type == "cpu":
        return crf.backward_scores(scores, n_base, state_len)
    _check(scores, "backward_scan", torch.float32, 3)
    scores = _ring_aligned(scores)
    T, N, _ = scores.shape
    ns = n_base ** state_len
    betas = torch.empty(T + 1, N, ns, device=scores.device)
    lib, fn = _fn("xna_crf_backward")
    rc = fn(scores.data_ptr(), betas.data_ptr(), T, N, n_base, ns,
            _stream())
    _build.check(lib, rc, "crf backward kernel", _SCAN_MESSAGES)
    backward_scan.launches += 1
    return betas


def forward_viterbi(scores: torch.Tensor, betas: torch.Tensor,
                    logz: torch.Tensor, n_base: int, state_len: int):
    """K2b: -> (backpointers [T, N, n_state] uint8, v_final [N, n_state])."""
    if scores.device.type == "cpu":
        return crf.forward_viterbi(scores, betas, logz, n_base,
                                   state_len)
    _check(scores, "forward_viterbi", torch.float32, 3)
    _check(betas, "forward_viterbi", torch.float32, 3)
    _check(logz, "forward_viterbi", torch.float32, 1)
    T, N, _ = scores.shape
    ns = n_base ** state_len
    if betas.shape != (T + 1, N, ns) or logz.shape != (N,):
        raise ValueError("forward_viterbi: betas/logz do not match scores")
    bp = torch.empty(T, N, ns, dtype=torch.uint8, device=scores.device)
    v_final = torch.empty(N, ns, device=scores.device)
    lib, fn = _fn("xna_crf_fwd_viterbi")
    rc = fn(scores.data_ptr(), betas.data_ptr(), logz.data_ptr(),
            bp.data_ptr(), v_final.data_ptr(), T, N, n_base, ns, _stream())
    _build.check(lib, rc, "crf forward-Viterbi kernel", _MESSAGES)
    forward_viterbi.launches += 1
    return bp, v_final


def viterbi_traceback(bp: torch.Tensor, v_final: torch.Tensor,
                      n_base: int, state_len: int) -> torch.Tensor:
    """K2c: -> labels [N, T] int8 in 0..n_base."""
    if bp.device.type == "cpu":
        return crf.viterbi_traceback(bp, v_final, n_base, state_len)
    _check(bp, "viterbi_traceback", torch.uint8, 3)
    _check(v_final, "viterbi_traceback", torch.float32, 2)
    T, N, ns = bp.shape
    if ns != n_base ** state_len or v_final.shape != (N, ns):
        raise ValueError("viterbi_traceback: shapes do not match")
    labels = torch.empty(N, T, dtype=torch.int8, device=bp.device)
    lib, fn = _fn("xna_crf_traceback")
    rc = fn(bp.data_ptr(), v_final.data_ptr(), labels.data_ptr(), T, N,
            n_base, ns, _stream())
    _build.check(lib, rc, "crf traceback kernel", _MESSAGES)
    viterbi_traceback.launches += 1
    return labels


def forward_scan(scores: torch.Tensor, n_base: int, state_len: int):
    """K4: scores [T, N, C] f32 -> (alphas [T+1, N, n_state] with alpha_0 =
    0, logZ [N] = logsumexp(alpha_T))."""
    if scores.device.type == "cpu":
        alphas = crf.forward_scores(scores, n_base, state_len)
        return alphas, crf.logz_from_alphas(alphas)
    scores = scores.contiguous()
    _check(scores, "forward_scan", torch.float32, 3)
    scores = _ring_aligned(scores)
    T, N, _ = scores.shape
    ns = n_base ** state_len
    alphas = torch.empty(T + 1, N, ns, device=scores.device)
    logz = torch.empty(N, device=scores.device)
    lib, fn = _fn("xna_crf_forward")
    rc = fn(scores.data_ptr(), alphas.data_ptr(), logz.data_ptr(), T, N,
            n_base, ns, _stream())
    _build.check(lib, rc, "crf forward kernel", _SCAN_MESSAGES)
    forward_scan.launches += 1
    return alphas, logz


def edge_posteriors(scores: torch.Tensor, alphas: torch.Tensor,
                    betas: torch.Tensor, logz: torch.Tensor,
                    ct: torch.Tensor | None = None) -> torch.Tensor:
    """K5b: the edge posteriors [T, N, C] from the scores, the [T+1, N,
    n_state] alphas and betas and logZ [N], times ``ct`` [N] when given."""
    if scores.device.type == "cpu":
        return crf.edge_posteriors(scores, alphas, betas, logz, ct)
    scores, alphas, betas, logz = (t.contiguous() for t in (
        scores, alphas, betas, logz))
    for t, nd in ((scores, 3), (alphas, 3), (betas, 3), (logz, 1)):
        _check(t, "edge_posteriors", torch.float32, nd)
    T, N, C = scores.shape
    ns = alphas.shape[-1]
    if alphas.shape != (T + 1, N, ns) or betas.shape != alphas.shape \
            or logz.shape != (N,) or C % ns:
        raise ValueError("edge_posteriors: alphas/betas/logz do not match "
                         "the scores")
    if ct is not None:
        ct = ct.contiguous()
        _check(ct, "edge_posteriors", torch.float32, 1)
        if ct.shape != (N,):
            raise ValueError("edge_posteriors: ct must be [N]")
    post = torch.empty_like(scores)
    lib, fn = _fn("xna_crf_posteriors")
    rc = fn(scores.data_ptr(), alphas.data_ptr(), betas.data_ptr(),
            logz.data_ptr(), None if ct is None else ct.data_ptr(),
            post.data_ptr(), T, N, C // ns - 1, ns, _stream())
    _build.check(lib, rc, "crf posterior kernel", _MESSAGES)
    edge_posteriors.launches += 1
    return post


def _lattice_inputs(name, stay, move, lengths):
    """Contiguous f32 stay [T, N, n] and move [T, N, n-1] on the card, and
    the lengths [N] as int32 there."""
    stay, move = stay.contiguous(), move.contiguous()
    _check(stay, name, torch.float32, 3)
    _check(move, name, torch.float32, 3)
    T, N, n = stay.shape
    if move.shape != (T, N, n - 1) or lengths.shape != (N,):
        raise ValueError(
            f"{name}: expected stay [T, N, n], move [T, N, n-1] and lengths "
            f"[N], got {tuple(stay.shape)}, {tuple(move.shape)}, "
            f"{tuple(lengths.shape)}")
    lengths = lengths.to(device=stay.device, dtype=torch.int32).contiguous()
    return stay, move, lengths


def lattice_forward(stay: torch.Tensor, move: torch.Tensor,
                    lengths: torch.Tensor):
    """K6a: -> (alphas [T, N, n], alpha_t before step t; logZ [N] at
    position clamp(length-1, 0, n-1))."""
    if stay.device.type == "cpu":
        return crf.lattice_forward(stay, move, lengths)
    stay, move, lengths = _lattice_inputs("lattice_forward", stay, move,
                                          lengths)
    T, N, n = stay.shape
    alphas = torch.empty_like(stay)
    logz = torch.empty(N, device=stay.device)
    lib, fn = _fn("xna_lattice_forward")
    rc = fn(stay.data_ptr(), move.data_ptr(), lengths.data_ptr(),
            alphas.data_ptr(), logz.data_ptr(), T, N, n, _stream())
    _build.check(lib, rc, "lattice forward kernel", _LATTICE_MESSAGES)
    lattice_forward.launches += 1
    return alphas, logz


def lattice_backward(stay: torch.Tensor, move: torch.Tensor,
                     lengths: torch.Tensor, alphas: torch.Tensor,
                     logz: torch.Tensor, ct: torch.Tensor):
    """K6b: -> (d_stay [T, N, n], d_move [T, N, n-1]), the lattice's edge
    posteriors times ``ct`` [N]."""
    if stay.device.type == "cpu":
        return crf.lattice_backward(stay, move, lengths, alphas, logz, ct)
    stay, move, lengths = _lattice_inputs("lattice_backward", stay, move,
                                          lengths)
    alphas, logz, ct = alphas.contiguous(), logz.contiguous(), \
        ct.contiguous()
    _check(alphas, "lattice_backward", torch.float32, 3)
    _check(logz, "lattice_backward", torch.float32, 1)
    _check(ct, "lattice_backward", torch.float32, 1)
    T, N, n = stay.shape
    if alphas.shape != stay.shape or logz.shape != (N,) \
            or ct.shape != (N,):
        raise ValueError("lattice_backward: alphas/logz/ct do not match")
    d_stay = torch.empty_like(stay)
    d_move = torch.empty_like(move)
    lib, fn = _fn("xna_lattice_backward")
    rc = fn(stay.data_ptr(), move.data_ptr(), lengths.data_ptr(),
            alphas.data_ptr(), logz.data_ptr(), ct.data_ptr(),
            d_stay.data_ptr(), d_move.data_ptr(), T, N, n, _stream())
    _build.check(lib, rc, "lattice backward kernel", _LATTICE_MESSAGES)
    lattice_backward.launches += 1
    return d_stay, d_move


backward_scan.launches = 0
forward_viterbi.launches = 0
viterbi_traceback.launches = 0
forward_scan.launches = 0
edge_posteriors.launches = 0
lattice_forward.launches = 0
lattice_backward.launches = 0


def decode_paths_cuda(scores: torch.Tensor, n_base: int, state_len: int):
    """The decode chain through the three kernels: scores [T, N, C] ->
    labels [N, T] int8, in f32.  logZ between K2a and K2b is one torch
    reduction."""
    scores = scores.float().contiguous()
    betas = backward_scan(scores, n_base, state_len)
    bp, v_final = forward_viterbi(scores, betas, crf.logz_from_betas(betas),
                                  n_base, state_len)
    return viterbi_traceback(bp, v_final, n_base, state_len)
