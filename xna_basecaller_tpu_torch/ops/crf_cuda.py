"""The CRF's hand-written CUDA kernels, with their wrappers.

K2a, K2b, K2c (``csrc/crf_decode.cu``): the Viterbi decode, replacing the
three Pallas kernels of
``xna_basecaller_tpu/ops/crf_pallas.py::decode_paths_pallas``
(``_bwd_kernel_unrolled``, ``_fwd_viterbi_kernel``, ``_traceback_kernel``);
their q-score variants (``forward_viterbi_qual``,
``viterbi_traceback_qual``) give each chosen transition's posterior, for
``decode_paths_with_qual_cuda``.

The beam kernel (``beam_search``, ``csrc/crf_beam.cu``): the step loop of
the path-collapsing beam decode, which the JAX package runs as XLA
(``ops/crf.py::decode_beam``); ``decode_beam_cuda`` runs K4, K2a and it.

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
recurrent vector in shared memory; the scans K2a/K5a, K2b, K4, K6a and K6b
read each step's rows from a ring that bulk copies keep in flight into
shared memory (``csrc/crf_ring.cuh``; K2b's span adds the row of betas it
needs); K2c copies a sequence's backpointers into shared memory in chunks
while one thread walks them.  The lattice kernels take stay and move packed
side by side (``lattice_pack``).

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
    "xna_crf_fwd_viterbi_qual": ("crf_decode",
                                 [_P] * 6 + [_I, _I, _I, _I, _P]),
    "xna_crf_traceback": ("crf_decode", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "xna_crf_traceback_qual": ("crf_decode",
                               [_P] * 5 + [_I, _I, _I, _I, _P]),
    "xna_crf_beam": ("crf_beam", [_P] * 7 + [_I] * 5 + [_P]),
    "xna_crf_forward": ("crf_loss", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "xna_crf_posteriors": ("crf_loss",
                           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "xna_lattice_forward": ("crf_loss", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "xna_lattice_backward": ("crf_loss",
                             [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "xna_lattice_depth": ("crf_loss", [_I, _I]),
}
_MESSAGES = {-2: "shape not supported by the kernel (n_state <= 256, "
                 "n_base + 1 <= 8, n_state * (n_base + 1) <= 2048)"}
_SCAN_MESSAGES = {**_MESSAGES, -3: "scores not 8-byte aligned"}
# the widest beam the beam kernel takes (``kMaxBeam``, csrc/crf_beam.cu)
MAX_BEAM_WIDTH = 256
_LATTICE_MESSAGES = {-2: "lattice not supported by the kernel (1 <= n <= "
                         "6144 positions)",
                     -3: "packed lattice or alphas not 16-byte aligned"}
_NEG = -1e38   # log(0) in the packed lattice's pads, as in the kernels


def _fn(name: str):
    source, argtypes = _SIGNATURES[name]
    lib = _build.load(source)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def _check(t: torch.Tensor, name: str, dtype, ndim: int,
           contiguous: bool = True):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    _build.check_device(name, t)
    if t.dtype != dtype or t.ndim != ndim \
            or (contiguous and not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ring_aligned(scores: torch.Tensor) -> torch.Tensor:
    """``scores`` as the ring of K2a/K5a, K2b and K4 takes them: starting
    8-byte aligned, so that every row is (``csrc/crf_ring.cuh``); a view
    that starts at an odd float is copied."""
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
        return crf.forward_viterbi(scores, betas, logz, n_base, state_len)
    return _forward_viterbi(scores, betas, logz, n_base, state_len, False)


def forward_viterbi_qual(scores: torch.Tensor, betas: torch.Tensor,
                         logz: torch.Tensor, n_base: int, state_len: int):
    """K2b's q-score variant: -> (bp, v_final, edge_sel [T, N, n_state]
    f32), edge_sel the raw edge of each chosen column; bp and v_final are
    ``forward_viterbi``'s."""
    if scores.device.type == "cpu":
        return crf.forward_viterbi(scores, betas, logz, n_base, state_len,
                                   qual=True)
    return _forward_viterbi(scores, betas, logz, n_base, state_len, True)


def _forward_viterbi(scores, betas, logz, n_base, state_len, qual):
    """Launch K2b, or its q-score variant with ``qual``, on the card."""
    _check(scores, "forward_viterbi", torch.float32, 3)
    _check(betas, "forward_viterbi", torch.float32, 3)
    _check(logz, "forward_viterbi", torch.float32, 1)
    scores = _ring_aligned(scores)
    T, N, _ = scores.shape
    ns = n_base ** state_len
    if betas.shape != (T + 1, N, ns) or logz.shape != (N,):
        raise ValueError("forward_viterbi: betas/logz do not match scores")
    bp = torch.empty(T, N, ns, dtype=torch.uint8, device=scores.device)
    v_final = torch.empty(N, ns, device=scores.device)
    ptrs = [scores.data_ptr(), betas.data_ptr(), logz.data_ptr(),
            bp.data_ptr(), v_final.data_ptr()]
    if qual:
        edge_sel = torch.empty(T, N, ns, device=scores.device)
        lib, fn = _fn("xna_crf_fwd_viterbi_qual")
        rc = fn(*ptrs, edge_sel.data_ptr(), T, N, n_base, ns, _stream())
    else:
        lib, fn = _fn("xna_crf_fwd_viterbi")
        rc = fn(*ptrs, T, N, n_base, ns, _stream())
    _build.check(lib, rc, "crf forward-Viterbi kernel", _SCAN_MESSAGES)
    if qual:
        forward_viterbi_qual.launches += 1
        return bp, v_final, edge_sel
    forward_viterbi.launches += 1
    return bp, v_final


def viterbi_traceback(bp: torch.Tensor, v_final: torch.Tensor,
                      n_base: int, state_len: int) -> torch.Tensor:
    """K2c: -> labels [N, T] int8 in 0..n_base."""
    if bp.device.type == "cpu":
        return crf.viterbi_traceback(bp, v_final, n_base, state_len)
    labels = _traceback_outputs(bp, v_final, n_base, state_len)
    lib, fn = _fn("xna_crf_traceback")
    rc = fn(bp.data_ptr(), v_final.data_ptr(), labels.data_ptr(),
            *bp.shape[:2], n_base, bp.shape[2], _stream())
    _build.check(lib, rc, "crf traceback kernel", _MESSAGES)
    viterbi_traceback.launches += 1
    return labels


def viterbi_traceback_qual(bp: torch.Tensor, v_final: torch.Tensor,
                           edge_sel: torch.Tensor, n_base: int,
                           state_len: int):
    """K2c's q-score variant, on the edge_sel of ``forward_viterbi_qual``:
    -> (labels [N, T] int8, probs [N, T] f32), the exp() of the chosen edge
    at each step of the path; labels are ``viterbi_traceback``'s."""
    if bp.device.type == "cpu":
        return crf.viterbi_traceback(bp, v_final, n_base, state_len,
                                     edge_sel)
    labels = _traceback_outputs(bp, v_final, n_base, state_len)
    _check(edge_sel, "viterbi_traceback", torch.float32, 3)
    if edge_sel.shape != bp.shape:
        raise ValueError("viterbi_traceback: edge_sel does not match bp")
    probs = torch.empty(labels.shape, device=bp.device)
    lib, fn = _fn("xna_crf_traceback_qual")
    rc = fn(bp.data_ptr(), v_final.data_ptr(), edge_sel.data_ptr(),
            labels.data_ptr(), probs.data_ptr(), *bp.shape[:2], n_base,
            bp.shape[2], _stream())
    _build.check(lib, rc, "crf traceback kernel (q-scores)", _MESSAGES)
    viterbi_traceback_qual.launches += 1
    return labels, probs


def _traceback_outputs(bp, v_final, n_base, state_len) -> torch.Tensor:
    """K2c's input checks; -> its labels [N, T] int8, unwritten."""
    _check(bp, "viterbi_traceback", torch.uint8, 3)
    _check(v_final, "viterbi_traceback", torch.float32, 2)
    T, N, ns = bp.shape
    if ns != n_base ** state_len or v_final.shape != (N, ns):
        raise ValueError("viterbi_traceback: shapes do not match")
    return torch.empty(N, T, dtype=torch.int8, device=bp.device)


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


def _npad(n: int) -> int:
    """Positions of a packed lattice row: n rounded up to 4 floats, so
    that every row is 16-byte aligned."""
    return -(-n // 4) * 4


def lattice_pack(stay: torch.Tensor, move: torch.Tensor) -> torch.Tensor:
    """The layout of the lattice kernels K6a and K6b, as the JAX package's
    ``_lat_pack`` lays it out: stay [T, N, n] and move [T, N, n-1] -> lat
    [T, N, 2, npad] (npad = n rounded up to 4), lat[:, :, 0, j] the stay at
    j, lat[:, :, 1, j] the move into j (move j-1), slot 0 of the move row
    and the pads -1e38.  One pass over stay and move, so that a step's rows
    of one sequence are one 16-byte aligned span of 2 npad floats."""
    T, N, n = stay.shape
    npad = _npad(n)
    neg = stay.new_full((1, 1, 1), _NEG)
    return torch.cat([stay, neg.expand(T, N, npad - n + 1), move,
                      neg.expand(T, N, npad - n)], 2).view(T, N, 2, npad)


def lattice_unpack(lat: torch.Tensor, n: int):
    """stay [T, N, n] and move [T, N, n-1] of a packed lattice (views)."""
    return lat[:, :, 0, :n], lat[:, :, 1, 1:n]


def _packed(stay: torch.Tensor, move: torch.Tensor) -> torch.Tensor:
    """The packed lattice whose ``lattice_unpack`` views ``stay`` and
    ``move`` are, without a copy (the loss hands its kernels such views);
    any other stay and move are packed."""
    T, N, n = stay.shape
    npad = _npad(n)
    strides = (2 * N * npad, 2 * npad, 1)
    if stay.stride() == strides and move.stride() == strides \
            and move.untyped_storage().data_ptr() \
            == stay.untyped_storage().data_ptr() \
            and move.storage_offset() == stay.storage_offset() + npad + 1 \
            and stay.data_ptr() % 16 == 0 \
            and stay.untyped_storage().nbytes() \
            >= 4 * (stay.storage_offset() + T * N * 2 * npad):
        return stay.as_strided((T, N, 2, npad), (2 * N * npad, 2 * npad,
                                                 npad, 1))
    return lattice_pack(stay, move)


def _padded(alphas: torch.Tensor, npad: int) -> torch.Tensor:
    """alphas [T, N, n] at row stride npad, 16-byte aligned, as K6a writes
    them (a view of them passes as it is, others are copied): [T, N,
    npad], of which the kernels read the first n positions."""
    T, N, n = alphas.shape
    if alphas.stride() == (N * npad, npad, 1) and alphas.data_ptr() % 16 == 0 \
            and alphas.untyped_storage().nbytes() \
            >= 4 * (alphas.storage_offset() + T * N * npad):
        return alphas.as_strided((T, N, npad), (N * npad, npad, 1))
    out = alphas.new_empty(T, N, npad)
    out[:, :, :n] = alphas
    return out


def _lattice_inputs(name, stay, move, lengths):
    """The packed lattice of f32 stay [T, N, n] and move [T, N, n-1] on the
    card, and the lengths [N] as int32 there."""
    _check(stay, name, torch.float32, 3, contiguous=False)
    _check(move, name, torch.float32, 3, contiguous=False)
    T, N, n = stay.shape
    if move.shape != (T, N, n - 1) or lengths.shape != (N,):
        raise ValueError(
            f"{name}: expected stay [T, N, n], move [T, N, n-1] and lengths "
            f"[N], got {tuple(stay.shape)}, {tuple(move.shape)}, "
            f"{tuple(lengths.shape)}")
    lengths = lengths.to(device=stay.device, dtype=torch.int32).contiguous()
    return _packed(stay, move), lengths


def lattice_forward(stay: torch.Tensor, move: torch.Tensor,
                    lengths: torch.Tensor):
    """K6a: -> (alphas [T, N, n], alpha_t before step t; logZ [N] at
    position clamp(length-1, 0, n-1)).  On the card the alphas are a view
    at row stride npad, which ``lattice_backward`` takes without a copy."""
    if stay.device.type == "cpu":
        return crf.lattice_forward(stay, move, lengths)
    lat, lengths = _lattice_inputs("lattice_forward", stay, move, lengths)
    T, N, _, npad = lat.shape
    n = stay.shape[2]
    alphas = torch.empty(T, N, npad, device=stay.device)
    logz = torch.empty(N, device=stay.device)
    lib, fn = _fn("xna_lattice_forward")
    rc = fn(lat.data_ptr(), lengths.data_ptr(), alphas.data_ptr(),
            logz.data_ptr(), T, N, n, _stream())
    _build.check(lib, rc, "lattice forward kernel", _LATTICE_MESSAGES)
    lattice_forward.launches += 1
    return alphas[:, :, :n], logz


def lattice_backward(stay: torch.Tensor, move: torch.Tensor,
                     lengths: torch.Tensor, alphas: torch.Tensor,
                     logz: torch.Tensor, ct: torch.Tensor):
    """K6b: -> (d_stay [T, N, n], d_move [T, N, n-1]), the lattice's edge
    posteriors times ``ct`` [N]."""
    if stay.device.type == "cpu":
        return crf.lattice_backward(stay, move, lengths, alphas, logz, ct)
    lat, lengths = _lattice_inputs("lattice_backward", stay, move, lengths)
    logz, ct = logz.contiguous(), ct.contiguous()
    _check(alphas, "lattice_backward", torch.float32, 3, contiguous=False)
    _check(logz, "lattice_backward", torch.float32, 1)
    _check(ct, "lattice_backward", torch.float32, 1)
    T, N, _, npad = lat.shape
    n = stay.shape[2]
    if alphas.shape != stay.shape or logz.shape != (N,) \
            or ct.shape != (N,):
        raise ValueError("lattice_backward: alphas/logz/ct do not match")
    alphas = _padded(alphas, npad)
    d_stay = torch.empty(T, N, n, device=stay.device)
    d_move = torch.empty(T, N, n - 1, device=stay.device)
    lib, fn = _fn("xna_lattice_backward")
    rc = fn(lat.data_ptr(), lengths.data_ptr(), alphas.data_ptr(),
            logz.data_ptr(), ct.data_ptr(), d_stay.data_ptr(),
            d_move.data_ptr(), T, N, n, _stream())
    _build.check(lib, rc, "lattice backward kernel", _LATTICE_MESSAGES)
    lattice_backward.launches += 1
    return d_stay, d_move


def lattice_depth(n: int, backward: bool) -> int:
    """The stages of the ring of K6a (or K6b, ``backward``) for a lattice
    of n positions: 8, or 4 or 2 where 8 do not fit in a block's shared
    memory (``csrc/crf_loss.cu``).  Needs the built kernels."""
    _, fn = _fn("xna_lattice_depth")
    return fn(n, int(backward))


def beam_search(scores: torch.Tensor, alphas: torch.Tensor,
                betas: torch.Tensor, logz: torch.Tensor, n_base: int,
                state_len: int, beam_width: int = 8):
    """The beam kernel: the path-collapsing beam search over the edges of
    scores [T, N, C] f32 with alphas and betas [T+1, N, n_state] and logZ
    [N] -> (labels [N, T] int8, best_score [N] f32).  Widths 1 to
    ``MAX_BEAM_WIDTH``; a wider beam raises ``ValueError``."""
    if scores.device.type == "cpu":
        return crf.beam_search(scores, alphas, betas, logz, n_base,
                               state_len, beam_width)
    if not 1 <= beam_width <= MAX_BEAM_WIDTH:
        raise ValueError(
            f"beam_search: beam width {beam_width} outside 1..."
            f"{MAX_BEAM_WIDTH}, the widths the beam kernel takes")
    scores, alphas, betas, logz = (t.contiguous() for t in (
        scores, alphas, betas, logz))
    for t, nd in ((scores, 3), (alphas, 3), (betas, 3), (logz, 1)):
        _check(t, "beam_search", torch.float32, nd)
    T, N, C = scores.shape
    ns = n_base ** state_len
    if C != ns * (n_base + 1) or alphas.shape != (T + 1, N, ns) \
            or betas.shape != alphas.shape or logz.shape != (N,):
        raise ValueError("beam_search: alphas/betas/logz do not match the "
                         "scores")
    hist = torch.empty(N, T, beam_width, dtype=torch.int16,
                       device=scores.device)
    labels = torch.empty(N, T, dtype=torch.int8, device=scores.device)
    best = torch.empty(N, device=scores.device)
    lib, fn = _fn("xna_crf_beam")
    rc = fn(scores.data_ptr(), alphas.data_ptr(), betas.data_ptr(),
            logz.data_ptr(), hist.data_ptr(), labels.data_ptr(),
            best.data_ptr(), T, N, n_base, ns, beam_width, _stream())
    _build.check(lib, rc, "crf beam kernel", {
        **_MESSAGES, -4: f"beam width outside 1..{MAX_BEAM_WIDTH}"})
    beam_search.launches += 1
    return labels, best


backward_scan.launches = 0
forward_viterbi.launches = 0
forward_viterbi_qual.launches = 0
viterbi_traceback.launches = 0
viterbi_traceback_qual.launches = 0
beam_search.launches = 0
forward_scan.launches = 0
edge_posteriors.launches = 0
lattice_forward.launches = 0
lattice_backward.launches = 0


def decode_paths_cuda(scores: torch.Tensor, n_base: int, state_len: int):
    """The decode chain through the three kernels: scores [T, N, C] ->
    labels [N, T] int8, in f32.  logZ between K2a and K2b is one torch
    reduction.  The scores are aligned for the ring once, for both scans."""
    scores = _ring_aligned(scores.float().contiguous())
    betas = backward_scan(scores, n_base, state_len)
    bp, v_final = forward_viterbi(scores, betas, crf.logz_from_betas(betas),
                                  n_base, state_len)
    return viterbi_traceback(bp, v_final, n_base, state_len)


def decode_paths_with_qual_cuda(scores: torch.Tensor, n_base: int,
                                state_len: int):
    """The q-score decode through its kernels: scores [T, N, C] -> (labels
    [N, T] int8, probs [N, T] f32, the posterior of each chosen
    transition), in f32: K2a, logZ (one torch reduction of the betas, as
    the Viterbi decode takes it, so that the labels are
    ``decode_paths_cuda``'s), the q-score K2b, then the q-score K2c.  On the
    CPU the plain ``crf.decode_paths_with_qual``, whose logZ comes from the
    alphas, as JAX's does."""
    if scores.device.type == "cpu":
        return crf.decode_paths_with_qual(scores, n_base, state_len)
    scores = _ring_aligned(scores.float().contiguous())
    betas = backward_scan(scores, n_base, state_len)
    bp, v_final, edge_sel = forward_viterbi_qual(
        scores, betas, crf.logz_from_betas(betas), n_base, state_len)
    del betas
    return viterbi_traceback_qual(bp, v_final, edge_sel, n_base, state_len)


def decode_beam_cuda(scores: torch.Tensor, n_base: int, state_len: int,
                     beam_width: int = 8):
    """The beam decode through its kernels: scores [T, N, C] -> (labels [N,
    T] int8, best_score [N] f32), in f32: K4 (alphas and logZ), K2a
    (betas), then the beam kernel.  On the CPU the plain
    ``crf.decode_beam``."""
    if scores.device.type == "cpu":
        return crf.decode_beam(scores, n_base, state_len, beam_width)
    if not 1 <= beam_width <= MAX_BEAM_WIDTH:
        raise ValueError(
            f"decode_beam_cuda: beam width {beam_width} outside 1..."
            f"{MAX_BEAM_WIDTH}, the widths the beam kernel takes")
    scores = _ring_aligned(scores.float().contiguous())
    alphas, logz = forward_scan(scores, n_base, state_len)
    betas = backward_scan(scores, n_base, state_len)
    return beam_search(scores, alphas, betas, logz, n_base, state_len,
                       beam_width)
