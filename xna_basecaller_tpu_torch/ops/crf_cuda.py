"""K2a, K2b, K2c: the CRF Viterbi decode as hand-written CUDA kernels
(``csrc/crf_decode.cu``), with their wrappers.

They replace the three Pallas kernels of
``xna_basecaller_tpu/ops/crf_pallas.py::decode_paths_pallas``
(``_bwd_kernel_unrolled``, ``_fwd_viterbi_kernel``, ``_traceback_kernel``).
Their bound on the card, and what the design does about it, is set out at
the top of the CUDA source: K2a and K2b are bound by reading the score
tensor (1.11 GB at flagship shapes) and by their 720 dependent steps; one
block per sequence keeps the recurrent vectors in shared memory and reads
each step's score row coalesced, prefetching the next one.

Each wrapper takes the plain version in ``ops/crf.py`` for a tensor on the
CPU, launches its kernel for a CUDA tensor, and raises for anything else;
``<wrapper>.launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from xna_basecaller_tpu_torch.ops import _build
from xna_basecaller_tpu_torch.ops.crf import (
    backward_scores, forward_viterbi as forward_viterbi_plain,
    logz_from_betas, viterbi_traceback as viterbi_traceback_plain,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "xna_crf_backward": [_P, _P, _I, _I, _I, _I, _P],
    "xna_crf_fwd_viterbi": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "xna_crf_traceback": [_P, _P, _P, _I, _I, _I, _I, _P],
}
_MESSAGES = {-2: "shape not supported by the kernel (n_state <= 256, "
                 "n_base + 1 <= 8, n_state * (n_base + 1) <= 2048)"}


def _fn(name: str):
    lib = _build.load("crf_decode")
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
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


def backward_scan(scores: torch.Tensor, n_base: int, state_len: int):
    """K2a: scores [T, N, C] f32 -> betas [T+1, N, n_state] (beta_T = 0)."""
    if scores.device.type == "cpu":
        return backward_scores(scores, n_base, state_len)
    _check(scores, "backward_scan", torch.float32, 3)
    T, N, _ = scores.shape
    ns = n_base ** state_len
    betas = torch.empty(T + 1, N, ns, device=scores.device)
    lib, fn = _fn("xna_crf_backward")
    rc = fn(scores.data_ptr(), betas.data_ptr(), T, N, n_base, ns,
            _stream())
    _build.check(lib, rc, "crf backward kernel", _MESSAGES)
    backward_scan.launches += 1
    return betas


def forward_viterbi(scores: torch.Tensor, betas: torch.Tensor,
                    logz: torch.Tensor, n_base: int, state_len: int):
    """K2b: -> (backpointers [T, N, n_state] uint8, v_final [N, n_state])."""
    if scores.device.type == "cpu":
        return forward_viterbi_plain(scores, betas, logz, n_base, state_len)
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
        return viterbi_traceback_plain(bp, v_final, n_base, state_len)
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


backward_scan.launches = 0
forward_viterbi.launches = 0
viterbi_traceback.launches = 0


def decode_paths_cuda(scores: torch.Tensor, n_base: int, state_len: int):
    """The decode chain through the three kernels: scores [T, N, C] ->
    labels [N, T] int8, in f32.  logZ between K2a and K2b is one torch
    reduction."""
    scores = scores.float().contiguous()
    betas = backward_scan(scores, n_base, state_len)
    bp, v_final = forward_viterbi(scores, betas, logz_from_betas(betas),
                                  n_base, state_len)
    return viterbi_traceback(bp, v_final, n_base, state_len)
