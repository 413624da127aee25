"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Marked ``gpu``; each test skips where there is no CUDA device.

Run them on a machine with the card:
    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Tolerances: f32 LSTM 1e-4 (the same math summed in another order over the
steps); bf16 LSTM 2e-2 absolute (a few bf16 ulps of |h| < 1, where an f32
ordering difference flips a rounding of h), for ys and for K3a's cell
states (|c| is a few units at most here: 5e-2); K3b's dxp relative to its
largest element, 1e-3 in f32 and 5e-2 in bf16 (the reverse recursion
carries dh and dc over every step, so a rounding flipped early in bf16
moves later steps by a few bf16 ulps of the largest gradient); betas and
logZ rtol 1e-5;
backpointers, labels and v_final of the same inputs exact, except for
the f32 near-ties that the decode tests of chip_smoke.py count.  The loss
kernels: alphas, betas and logZ (K4, K6a) rtol 1e-5; the edge posteriors
(K5b, from the same alphas and betas) rtol 1e-4 with atol 1e-7; the
lattice gradients (K6b) and the gradient of ``ctc_loss`` (kernels on the
card against the plain path on the CPU) within 1e-4 of their largest
element, because each is exp() of a difference of log-sums that
magnifies the last bits of the scans.  The CRF scans give the same
betas, alphas and logZ bit for bit whichever route brings their rows:
the same operations in the same order; so do the lattice scans (K6a,
K6b) whether stay and move come as the loss's packed views, as contiguous
tensors or as the slices of the loss's gather.  The int8 recurrence (K7): as
K1, f32 1e-4 and bf16 2e-2 absolute, and in bf16 at most 1e-3 of ys
differing at all (the bf16 h at even steps; without that rule about 30 %
differ).  The q-score K2b: bp and v_final bit-equal to the Viterbi K2b's,
edge_sel within 4 ulps of |logZ| of the plain version's; the q-score K2c:
labels bit-equal, probs within 1e-6.  The beam kernel: best_score within
1e-4 (rtol 1e-6) of the plain beam's on the same partials, labels equal
wherever the winner leads the best other sequence by more than 1e-4, and
such near ties in at most one row in 16.
"""

import math

import numpy as np
import pytest
import torch

from xna_basecaller_tpu_torch.ops import crf, crf_cuda, lstm, lstm_cuda
from xna_basecaller_tpu_torch.ops._build import launches

pytestmark = pytest.mark.gpu


def _decode_wide():
    """Launches of K2a, K2b and K2c on the decode's wide path."""
    return sum(launches[f"{k}.wide"] for k in (
        "backward_scan", "forward_viterbi", "viterbi_traceback"))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


def _lstm_inputs(T, N, H, seed, device, dtype):
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(T, N, 4 * H, generator=g)
    w = torch.randn(H, 4 * H, generator=g) / H ** 0.5
    return xp.to(device, dtype), w.to(device, dtype)


# Batch sizes and widths of the launch geometry.  bf16: 1, 5, 8, 16, 32,
# 33, 42, 43 and 64 rows take the cluster path (N <= 64); 65 up to 384 one
# launch of the rows kernel: 65, 127 and 128 one tile of 128 rows (65: one
# row in the last 16-row block), 129 and 130 a second tile of 1 or 2 rows,
# 200 a second tile of 72 rows, 255 and 256 two tiles; 257, 300 and 384
# three tiles of 128 rows at H=64 and 96, and at H=768 (where 144 CTAs of
# 128 rows do not fit the card) the wide geometry: two tiles of 192 rows,
# the second of 65, 108 or 192 (the split geometry, clusters of 2 CTAs
# splitting W_hh's depth, takes H >= 1024 only: _REPEAT_CASES and
# test_k1_at_1024_takes_split_and_is_bit_repeatable run it); 385 two
# launches (at most 384 rows each),
# the second of 1 row on the cluster path.  f32: at most 256 rows a
# launch (257-385 two); all N rows in one block up to 42 (6 units a CTA,
# H=96 and 768) or 32 (8 units, H=64), past that blocks of at most 41 rows
# (two of 32 at N=64, seven of 37 and 34 at N=256, two of 22 and 21 at
# N=43, two of 17 and 16 at N=33 and H=64) double buffered; 1, 5 and 33
# rows a last product of fewer than 4 rows.  H=96: a part-width h chunk (bf16), a
# depth slice of 48 rows a CTA of which five warps hold none (f32); H=768
# the flagship width, at T=300 for N=64 and N=256 (a lost flag or a
# missing fence shows as rare wrong values only over many steps).
_LSTM_N = [1, 5, 8, 16, 32, 33, 42, 43, 64, 65, 127, 128, 129, 130, 200, 255,
           256, 257, 300, 384, 385]
_LSTM_H = [64, 96, 768]


def _steps(N, H, T):
    return 300 if (N, H) in ((64, 768), (256, 768)) else T


# csrc/lstm_recurrence.cu's kSplitMinH: the narrowest H on the split
# geometry
SPLIT_MIN_H = 1024


def _k1_launches(N, H, dtype):
    """K1's launches over N rows of width H, and those of them on the wide
    and on the split geometry: a bf16 launch of more than 64 rows takes the
    split where H >= SPLIT_MIN_H is a multiple of 128 and its grid (one
    CTA an SM of 16 units and 128 rows) fits the card's SMs, else the wide
    geometry where that grid would need more CTAs than the card has
    SMs."""
    group = lstm_cuda.group_rows("lstm_recurrence", dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = [r for r in (min(group, N - n0) for n0 in range(0, N, group))
            if dtype == torch.bfloat16 and r > 64]
    fits = [-(-r // 128) * (H // 16) <= sms for r in rows]
    split = sum(f and H >= SPLIT_MIN_H and H % 128 == 0 for f in fits)
    return -(-N // group), fits.count(False), split


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N", _LSTM_N)
@pytest.mark.parametrize("H", _LSTM_H)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_kernel_matches_plain(cuda, dtype, atol, N, H, reverse):
    xp, w = _lstm_inputs(_steps(N, H, 40), N, H, seed=N, device=cuda,
                         dtype=dtype)
    k1 = lstm_cuda.lstm_recurrence
    keys = ("lstm_recurrence", "lstm_recurrence.wide",
            "lstm_recurrence.split")
    before = [launches[k] for k in keys]
    got = lstm_cuda.lstm_recurrence(xp, w, reverse)
    torch.cuda.synchronize()
    n_launches, wide, split = _k1_launches(N, H, dtype)
    assert [launches[k] - b for k, b in zip(keys, before)] \
        == [n_launches, wide, split]
    if dtype == torch.bfloat16 and H == 768:
        assert wide == (N > 256)   # one launch of 257-384 rows
    assert split == 0   # none of these widths takes the split
    want = lstm.lstm_recurrence(xp, w, reverse)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


# bf16: 65-256 one launch of the wgmma kernel (one or two row tiles of
# 128): at H=768 3 chunks of 256 columns on 2 ring stages; at H=1024 the
# split geometry, clusters of 2 CTAs each reading its depth slice of h in
# 4 chunks of 128 columns on 2 stages (65: one row in a tile's last 16-row
# block; 200: a second tile of 72 rows); 257, 300 and 384 one launch on
# the wide geometry (two tiles of 192 rows, 6 or 8 chunks of 128 columns
# on 2 stages); 385 two launches, the second on the cluster path.  f32:
# 1, 8 and 32 rows in one block; 64, 65 and 256 in blocks double
# buffered, 257 two launches; H=768: 6 units a CTA, H=1024: 8
_REPEAT_CASES = ([(torch.bfloat16, n)
                  for n in (65, 128, 200, 256, 257, 300, 384, 385)]
                 + [(torch.float32, n) for n in (1, 8, 32, 64, 65, 256, 257)])


@pytest.mark.parametrize("cells", [False, True])
@pytest.mark.parametrize("dtype,N", _REPEAT_CASES)
@pytest.mark.parametrize("H", [768, 1024])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_kernels_are_bit_repeatable(cuda, cells, dtype, N, H, reverse):
    """K1 and K3a give the same bits over 6 calls, in bf16 and in f32: the
    chunks of h finish in another order each call, and the kernels add
    their products in one fixed order all the same; and the plain
    version's values (the tolerances of the tests above; f32 1e-4 for ys
    and the cells)."""
    xp, w = _lstm_inputs(300, N, H, seed=N + 7, device=cuda, dtype=dtype)
    fn = (lstm_cuda.lstm_forward_with_cells if cells
          else lambda x, w, r: (lstm_cuda.lstm_recurrence(x, w, r),))
    first = fn(xp, w, reverse)
    for _ in range(5):
        for got, want in zip(fn(xp, w, reverse), first):
            assert torch.equal(got, want)
    plain = (lstm.lstm_recurrence_with_cells(xp, w, reverse) if cells
             else (lstm.lstm_recurrence(xp, w, reverse),))
    tols = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 5e-2)
    for got, want, atol in zip(first, plain, tols):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("cells", [False, True])
@pytest.mark.parametrize("H", [768, 1024])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_384_rows_equal_two_launches(cuda, cells, H, reverse):
    """K1 (and K3a) over 384 bf16 rows, one launch (on the wide geometry at
    H=768 and 1024), equals bit for bit the same kernel run apart on the
    first 256 rows and on the last 128 (the two launches it replaces): a
    row's gates sum the same k16 products in the same order whatever its
    tile.  At H=1024, where 65-256 rows take the split geometry (which adds
    the two depth slices' sums: other bits), the split's 256 rows in one
    launch equal its two launches of 128 rows instead, and the wide
    launch of 384 rows is held to the plain version (2e-2, 5e-2)."""
    xp, w = _lstm_inputs(300, 384, H, seed=H + 384, device=cuda,
                         dtype=torch.bfloat16)
    fn = (lstm_cuda.lstm_forward_with_cells if cells
          else lambda x, w, r: (lstm_cuda.lstm_recurrence(x, w, r),))
    assert lstm_cuda.bf16_geometry(384, H)["geometry"] == "wide"
    split = lstm_cuda.bf16_geometry(256, H)["geometry"] == "split"
    assert split == (H >= SPLIT_MIN_H)
    cuts = ((0, 128), (128, 256)) if split else ((0, 256), (256, 384))
    whole = fn(xp[:, :cuts[-1][1]].contiguous(), w, reverse)
    parts = [fn(xp[:, a:b].contiguous(), w, reverse) for a, b in cuts]
    torch.cuda.synchronize()
    for i, got in enumerate(whole):
        assert torch.equal(got, torch.cat([p[i] for p in parts], dim=1))
    if split:
        plain = (lstm.lstm_recurrence_with_cells(xp, w, reverse) if cells
                 else (lstm.lstm_recurrence(xp, w, reverse),))
        for got, want, atol in zip(fn(xp, w, reverse), plain, (2e-2, 5e-2)):
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=atol)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
# the rows of the launch geometry as for K1 (the cluster path excepted:
# every N takes K7's one design); 257 and 300: two launches
@pytest.mark.parametrize("N", [5, 65, 127, 128, 129, 130, 200, 255, 256, 257,
                               300])
@pytest.mark.parametrize("H", _LSTM_H)
@pytest.mark.parametrize("reverse", [False, True])
def test_int8_lstm_kernel_matches_plain(cuda, dtype, atol, N, H, reverse):
    """K7 against its plain version, on the int8 weights and scales of
    ``quantize_w_hh``; T odd, so the last step is an even one (T=301 at
    N=256, H=768)."""
    T = 301 if (N, H) == (256, 768) else 41
    xp, w = _lstm_inputs(T, N, H, seed=N + H, device=cuda, dtype=dtype)
    w_q, scale = lstm.quantize_w_hh(w)
    before = launches["lstm_recurrence_int8"]
    got = lstm_cuda.lstm_recurrence_int8(xp, w_q, scale, reverse)
    torch.cuda.synchronize()
    group = lstm_cuda.group_rows("lstm_int8", dtype)
    assert launches["lstm_recurrence_int8"] == before + -(-N // group)
    want = lstm.lstm_recurrence_int8(xp, w_q, scale, reverse)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    if dtype == torch.bfloat16:
        assert (got != want).float().mean().item() <= 1e-3


# 17 x 13 @ 13 x 625: a 5-letter model's head width; 5 rows: fewer than
# torch._int_mm takes; 300 x 768 @ 768 x 625: the head of a 5-letter model
@pytest.mark.parametrize("rows,K,M", [(17, 13, 625), (5, 768, 1512),
                                      (300, 768, 625)])
def test_int8_matmul_any_shape_on_card(cuda, rows, K, M):
    """``int8_matmul(x, *quantize_w_hh(w))`` on the card, padded for
    cuBLASLt, equals the product of the plain quantization exactly."""
    g = torch.Generator().manual_seed(rows + K + M)
    x, w = torch.randn(rows, K, generator=g), torch.randn(K, M, generator=g)
    got = lstm.int8_matmul(x.to(cuda), *lstm.quantize_w_hh(w.to(cuda)))
    w_q, w_s = lstm.quantize_w_hh(w)
    xs = torch.clamp(x.abs().amax(), min=1e-8) * (1.0 / 127.0)
    x_q = torch.round(x / xs).clamp(-127, 127).long()
    want = (x_q @ w_q.long()).float() * (xs * w_s)
    assert got.shape == (rows, M)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def _scores(n_base, state_len, T, N, seed, device):
    C = (n_base + 1) * n_base ** state_len
    g = torch.Generator().manual_seed(seed)
    return (torch.tanh(torch.randn(T, N, C, generator=g)) * 5).to(device)


@pytest.mark.parametrize("n_base,state_len", [(6, 3), (4, 2)])
def test_decode_kernels_match_plain(cuda, n_base, state_len):
    s = _scores(n_base, state_len, 50, 7, seed=1, device=cuda)
    betas = crf_cuda.backward_scan(s, n_base, state_len)
    want_betas = crf.backward_scores(s, n_base, state_len)
    torch.testing.assert_close(betas, want_betas, rtol=1e-5, atol=1e-5)
    logz = crf.logz_from_betas(betas)
    bp, v = crf_cuda.forward_viterbi(s, betas, logz, n_base, state_len)
    bp_p, v_p = crf.forward_viterbi(s, betas, logz, n_base, state_len)
    assert bp.dtype == torch.uint8
    assert (bp != bp_p).float().mean().item() <= 1e-3
    torch.testing.assert_close(v, v_p, rtol=1e-5, atol=1e-4)
    labels = crf_cuda.viterbi_traceback(bp, v, n_base, state_len)
    torch.testing.assert_close(
        labels, crf.viterbi_traceback(bp, v, n_base, state_len),
        rtol=0, atol=0)
    torch.cuda.synchronize()
    full = crf_cuda.decode_paths_cuda(s, n_base, state_len)
    want = crf.decode_paths(s.cpu(), n_base, state_len)
    assert (full.cpu() != want).float().mean().item() <= 1e-3



# The decode's wide path (csrc/crf_decode.cu, past 256 states): NACGT at
# state_len 5, 1024 states x 5 columns, at the R10.4.1 sup model's 2000
# frames a chunk, N=16 and its basecall batch of 256 (rows of 20 KB by
# bulk copy); NACGTX at state_len 4, 625 states x 6 (rows of 3750 f32, not
# a multiple of 16 bytes: cp.async of 8 bytes, betas read a step ahead).
@pytest.mark.parametrize("nb,sl,T,N", [(4, 5, 2000, 16), (4, 5, 2000, 256),
                                       (5, 4, 300, 16)])
def test_decode_kernels_match_plain_on_the_wide_path(cuda, nb, sl, T, N):
    """K2a, K2b and K2c on the wide path against their plain versions:
    betas rtol 1e-5, backpointers and the chain's labels equal but for f32
    near-ties (at most 1e-3), K2c's labels of the same backpointers exact;
    v_final, a best path's sum of T terms, within T x 1e-7 relative (the
    plain version's exp() and log() differ from the kernel's by an ulp here
    and there: 7.1e-5 at most read at T=2000 on an H100); one launch each,
    each counted in ``launches["<wrapper>.wide"]``."""
    s = _card_scores(nb, sl, T, N, seed=N)
    wide = _decode_wide()
    betas = crf_cuda.backward_scan(s, nb, sl)
    torch.testing.assert_close(betas, crf.backward_scores(s, nb, sl),
                               rtol=1e-5, atol=1e-5)
    logz = crf.logz_from_betas(betas)
    bp, v = crf_cuda.forward_viterbi(s, betas, logz, nb, sl)
    bp_p, v_p = crf.forward_viterbi(s, betas, logz, nb, sl)
    assert bp.dtype == torch.uint8
    assert (bp != bp_p).float().mean().item() <= 1e-3
    torch.testing.assert_close(v, v_p, rtol=1e-7 * T, atol=1e-4)
    labels = crf_cuda.viterbi_traceback(bp, v, nb, sl)
    assert torch.equal(labels, crf.viterbi_traceback(bp, v, nb, sl))
    assert _decode_wide() == wide + 3
    full = crf_cuda.decode_paths_cuda(s, nb, sl)
    want = crf.decode_paths(s, nb, sl)
    assert (full != want).float().mean().item() <= 1e-3


@pytest.mark.parametrize("n_base,state_len,wide", [
    (4, 5, 1), (6, 3, 0), (4, 4, 0)])
def test_crf_decode_launches_wide_counts_the_wide_path(cuda, n_base,
                                                       state_len, wide):
    """``launches["<wrapper>.wide"]`` counts 1 for each launch of K2a,
    K2b and K2c that took the wide path (1024 states) and 0 for the others
    (216 and 256 states); every launch counts in ``launches[<wrapper>]``."""
    s = _card_scores(n_base, state_len, 40, 8, seed=3)
    before = (_decode_wide(), launches["backward_scan"],
              launches["forward_viterbi"], launches["viterbi_traceback"])
    crf_cuda.decode_paths_cuda(s, n_base, state_len)
    torch.cuda.synchronize()
    after = (_decode_wide(), launches["backward_scan"],
             launches["forward_viterbi"], launches["viterbi_traceback"])
    assert [a - b for a, b in zip(after, before)] == [3 * wide, 1, 1, 1]


def test_the_wide_path_refuses_what_it_does_not_take(cuda):
    """Past 1024 states (NACGTX at state_len 4: 1296) the decode raises
    with the wide rule; the q-score variant of K2b, the loss's forward
    scan and the beam keep the first path's rule."""
    s = _card_scores(5, 4, 8, 2, seed=5)
    with pytest.raises(RuntimeError, match="n_state <= 1024"):
        crf_cuda.decode_paths_cuda(_card_scores(6, 4, 8, 2, seed=5), 6, 4)
    betas = crf_cuda.backward_scan(s, 5, 4)        # 625 states: wide
    logz = crf.logz_from_betas(betas)
    with pytest.raises(RuntimeError, match="n_state <= 256"):
        crf_cuda.forward_viterbi_qual(s, betas, logz, 5, 4)
    with pytest.raises(RuntimeError, match="n_state <= 256"):
        crf_cuda.forward_scan(s, 5, 4)


# sha256 of betas, v_final, backpointers and labels of K2a, K2b and K2c at
# the first path's shapes, on scores of integer thousandths drawn on the
# host (``tools/k2_turns.py::first_path_inputs``), as the kernels before
# the wide path gave them on an H100 80GB HBM3 (``k2_turns --baseline``)
_FIRST_PATH_SHA256 = {
    (6, 3): "4be8347276b89522352c869260d974779e3eff90a75a8aca3f775d5efa63f185",
    (4, 4): "b6f75ea38c752becfb2692c9a471b24a3fc0333a04f4b1097b43978eaf86f592",
}


@pytest.mark.parametrize("n_base,state_len", sorted(_FIRST_PATH_SHA256))
def test_decode_kernels_of_the_first_path_keep_their_bits(cuda, n_base,
                                                          state_len):
    """At 216 and 256 states the decode runs the kernels it ran before the
    wide path, bit for bit: the digests of their outputs are those the
    kernels before it gave."""
    from xna_basecaller_tpu_torch.tools import k2_turns
    s = k2_turns.first_path_inputs(n_base, state_len).to(cuda)
    betas = crf_cuda.backward_scan(s, n_base, state_len)
    bp, v = crf_cuda.forward_viterbi(s, betas, crf.logz_from_betas(betas),
                                     n_base, state_len)
    labels = crf_cuda.viterbi_traceback(bp, v, n_base, state_len)
    assert k2_turns.digest(betas, v, bp, labels) == \
        _FIRST_PATH_SHA256[(n_base, state_len)]


def test_k1_at_1024_takes_split_and_is_bit_repeatable(cuda):
    """K1 at the R10.4.1 sup model's width and batch (H=1024, N=256) over
    its 2000-step chain: the split geometry (two tiles of 128 rows, 128
    CTAs in clusters of 2, co-resident; each CTA's depth slice of h in 4
    chunks of 128 columns on 2 stages), one launch a call on it, counted
    in ``launches["lstm_recurrence.split"]``, the same bits twice, and the
    plain version's values within bf16's 2e-2."""
    geo = lstm_cuda.bf16_geometry(256, 1024)
    assert geo == {"geometry": "split", "rows": 128, "ctas": 128,
                   "chunk_cols": 128, "stages": 2}
    xp, w = _lstm_inputs(2000, 256, 1024, seed=11, device=cuda,
                         dtype=torch.bfloat16)
    k1 = lstm_cuda.lstm_recurrence
    keys = ("lstm_recurrence", "lstm_recurrence.wide",
            "lstm_recurrence.split")
    before = [launches[k] for k in keys]
    first = k1(xp, w, True)
    assert torch.equal(k1(xp, w, True), first)
    assert [launches[k] - b for k, b in zip(keys, before)] == [2, 0, 2]
    torch.testing.assert_close(first.float(),
                               lstm.lstm_recurrence(xp, w, True).float(),
                               rtol=0, atol=2e-2)

# The CRF scans' ring of score rows (csrc/crf_ring.cuh) is _RING_D stages
# deep: T at its edges (below, at and one past the depth), and
# T=300.  N: one row; 75, the last basecall batch of chip_smoke.py's reads;
# the basecall batch; 300, past it.
# Alphabets: (5, 3) has rows of 125 x 6 f32 = 3000 B, not a multiple of 16
# bytes, which take cp.async of 8 bytes; the others the bulk copy.  The
# kernels are built with n_base 4, 5 and 6 as constants; (7, 2) takes the
# build that reads it at run time, with the most columns they take (8).
_RING_D = 8
_RING_T = [1, 2, _RING_D - 1, _RING_D, _RING_D + 1, 300]
_RING_N = [1, 75, 256, 300]
_RING_ALPHABETS = [(4, 2), (5, 3), (6, 3), (7, 2)]


def _card_scores(n_base, state_len, T, N, seed, offset=0):
    """tanh(randn) x 5 made on the card, starting ``offset`` floats into
    its allocation (offset 1 or 2: rows aligned to 4 or 8 bytes only)."""
    C = (n_base + 1) * n_base ** state_len
    g = torch.Generator("cuda").manual_seed(seed)
    flat = torch.tanh(torch.randn(offset + T * N * C, device="cuda",
                                  generator=g)) * 5
    return flat[offset:].view(T, N, C)


def _scan_launches():
    return (launches["backward_scan"], launches["forward_scan"])


def _scans_against_plain(s, n_base, state_len):
    """betas, alphas and logZ of the kernels, held to the plain versions."""
    betas = crf_cuda.backward_scan(s, n_base, state_len)
    alphas, logz = crf_cuda.forward_scan(s, n_base, state_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        betas, crf.backward_scores(s, n_base, state_len), rtol=1e-5,
        atol=1e-5)
    want = crf.forward_scores(s, n_base, state_len)
    torch.testing.assert_close(alphas, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logz, crf.logz_from_alphas(want), rtol=1e-5,
                               atol=1e-5)
    return betas, alphas, logz


@pytest.mark.parametrize("n_base,state_len", _RING_ALPHABETS)
@pytest.mark.parametrize("N", _RING_N)
@pytest.mark.parametrize("T", _RING_T)
def test_crf_scans_match_plain(cuda, T, N, n_base, state_len):
    """K2a/K5a (backward_scan) and K4 (forward_scan), at the ring's edges,
    against their plain versions; one launch each."""
    s = _card_scores(n_base, state_len, T, N, seed=T * 1000 + N)
    before = _scan_launches()
    _scans_against_plain(s, n_base, state_len)
    assert _scan_launches() == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("n_base,state_len", _RING_ALPHABETS)
def test_crf_scans_take_rows_at_any_alignment(cuda, offset, n_base,
                                              state_len):
    """Scores that start 8 bytes into their allocation take cp.async of 8
    bytes, and those that start 4 bytes in are copied by the wrapper:
    betas, alphas and logZ bit-equal to those of the same scores 16-byte
    aligned (the same operations in the same order), and within 1e-5 of
    the plain versions."""
    for T in (_RING_D + 1, 300):
        s = _card_scores(n_base, state_len, T, 75, seed=offset,
                         offset=offset)
        assert s.data_ptr() % 16 == 4 * offset
        got = _scans_against_plain(s, n_base, state_len)
        aligned = s.clone()
        assert aligned.data_ptr() % 16 == 0
        want = (crf_cuda.backward_scan(aligned, n_base, state_len),
                *crf_cuda.forward_scan(aligned, n_base, state_len))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _decode_launches():
    return launches["forward_viterbi"], launches["viterbi_traceback"]


def _viterbi_inputs(s, n_base, state_len):
    betas = crf_cuda.backward_scan(s, n_base, state_len)
    return betas, crf.logz_from_betas(betas)


@pytest.mark.parametrize("n_base,state_len", _RING_ALPHABETS)
@pytest.mark.parametrize("N", _RING_N)
@pytest.mark.parametrize("T", _RING_T)
def test_decode_kernels_match_plain_at_the_ring_edges(cuda, T, N, n_base,
                                                      state_len):
    """K2b (forward_viterbi, on the ring with the betas row in its span
    where n_state is a multiple of 4) and K2c (viterbi_traceback, chunks
    of backpointers in shared memory) at the ring's edges, against their
    plain versions on the same betas and logZ: backpointers within the
    f32 near-ties (at most 1e-3 of them), the labels of the same bp and
    v_final identical; one launch each.  v_final within 1e-6 T^2 (at
    least 1e-4) and rtol 1e-5: each step's edge is a difference of alpha,
    beta and logZ, which grow ~5 a step, so the two versions' last-bit
    differences in those (another lse order, other exp/log) reach an edge
    as ~1e-6 T, and v_final sums T of them (T=300: 0.018 seen, 0.09
    allowed; a wrong row moves it by units)."""
    s = _card_scores(n_base, state_len, T, N, seed=T * 1000 + N + 7)
    betas, logz = _viterbi_inputs(s, n_base, state_len)
    before = _decode_launches()
    bp, v = crf_cuda.forward_viterbi(s, betas, logz, n_base, state_len)
    labels = crf_cuda.viterbi_traceback(bp, v, n_base, state_len)
    torch.cuda.synchronize()
    assert _decode_launches() == (before[0] + 1, before[1] + 1)
    bp_p, v_p = crf.forward_viterbi(s, betas, logz, n_base, state_len)
    assert bp.dtype == torch.uint8 and bp.shape == bp_p.shape
    assert (bp != bp_p).float().mean().item() <= 1e-3
    torch.testing.assert_close(v, v_p, rtol=1e-5,
                               atol=max(1e-4, 1e-6 * T * T))
    torch.testing.assert_close(
        labels, crf.viterbi_traceback(bp, v, n_base, state_len), rtol=0,
        atol=0)


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("n_base,state_len", _RING_ALPHABETS)
def test_forward_viterbi_takes_rows_at_any_alignment(cuda, offset, n_base,
                                                     state_len):
    """Scores that start 4 or 8 bytes into their allocation (copied by the
    wrapper, or taking cp.async of 8 bytes with beta_{t+1} read from
    device memory), and betas that start at an odd float (off the span):
    backpointers and v_final bit-equal to those of the same scores and
    betas 16-byte aligned."""
    for T in (_RING_D + 1, 300):
        s = _card_scores(n_base, state_len, T, 75, seed=offset,
                         offset=offset)
        assert s.data_ptr() % 16 == 4 * offset
        aligned = s.clone()
        betas, logz = _viterbi_inputs(aligned, n_base, state_len)
        want = crf_cuda.forward_viterbi(aligned, betas, logz, n_base,
                                        state_len)
        got = crf_cuda.forward_viterbi(s, betas, logz, n_base, state_len)
        odd = torch.empty(betas.numel() + 1, device="cuda")[1:].view_as(
            betas)
        odd.copy_(betas)
        assert odd.data_ptr() % 16 == 4
        off_span = crf_cuda.forward_viterbi(aligned, odd, logz, n_base,
                                            state_len)
        for out in (got, off_span):
            assert all(torch.equal(a, b) for a, b in zip(out, want))


# K2c's chunks of backpointer rows: 219 steps of 216 states, 384 of 125,
# 768 of 49, 3072 of 16 or 36 (tb_chunk, csrc/crf_decode.cu); rows of 16
# or 216 bytes take cp.async of 8 bytes, of 36, 49 or 125 (or at an odd
# address) plain loads.
@pytest.mark.parametrize("bp_offset", [0, 1])
@pytest.mark.parametrize("n_base,state_len",
                         [(4, 2), (5, 3), (6, 2), (6, 3), (7, 2)])
@pytest.mark.parametrize("T", [1, 2, 219, 220, 720, 5000])
def test_traceback_starts_at_the_first_maximum(cuda, T, n_base, state_len,
                                               bp_offset):
    """K2c on hand-made backpointers and a v_final whose maximum ties at
    several states (state 0, the last state, or states between): labels
    identical to the plain traceback's, which starts at the first
    maximum, as jnp.argmax does."""
    ns = n_base ** state_len
    N = 7
    rng = np.random.default_rng(T * 10 + ns)
    flat = torch.from_numpy(rng.integers(
        0, n_base + 1, size=bp_offset + T * N * ns, dtype=np.uint8))
    bp = flat.to(cuda)[bp_offset:].view(T, N, ns)
    v = rng.standard_normal((N, ns)).astype(np.float32)
    ties = [[0, ns - 1], [ns - 1, ns // 2], [1, 2, ns - 1], [ns // 3], [0],
            list(range(ns)), [ns - 2, ns - 1]]
    for n, states in enumerate(ties):
        v[n, states] = 9.0
    v_final = torch.from_numpy(v).to(cuda)
    before = _decode_launches()[1]
    labels = crf_cuda.viterbi_traceback(bp, v_final, n_base, state_len)
    torch.cuda.synchronize()
    assert _decode_launches()[1] == before + 1
    torch.testing.assert_close(
        labels, crf.viterbi_traceback(bp, v_final, n_base, state_len),
        rtol=0, atol=0)


def _max_rel(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype,atol,rtol_dxp", [(torch.float32, 1e-4, 1e-3),
                                                 (torch.bfloat16, 5e-2, 5e-2)])
# 64: the training batch; 16: the validation batch; 65, 100, 128 and 257:
# two or more launches of K3b in bf16 (at most 64 rows each), the last
# part-filled
@pytest.mark.parametrize("N", [1, 16, 64, 65, 100, 128, 257])
@pytest.mark.parametrize("H", _LSTM_H)
@pytest.mark.parametrize("reverse", [False, True])
def test_trainable_lstm_kernels_match_plain(cuda, dtype, atol, rtol_dxp, N,
                                            H, reverse):
    """K3a (ys and cells) and K3b (dxp) against their plain versions."""
    T = _steps(N, H, 33)
    xp, w = _lstm_inputs(T, N, H, seed=N + 1, device=cuda, dtype=dtype)
    before = (launches["lstm_forward_with_cells"],
              launches["lstm_backward_dxp"])
    ys, cs = lstm_cuda.lstm_forward_with_cells(xp, w, reverse)
    torch.cuda.synchronize()
    ys_p, cs_p = lstm.lstm_recurrence_with_cells(xp, w, reverse)
    assert ys.dtype == cs.dtype == dtype
    torch.testing.assert_close(ys.float(), ys_p.float(), rtol=0, atol=atol)
    torch.testing.assert_close(cs.float(), cs_p.float(), rtol=0,
                               atol=max(atol, 5e-2 if dtype != torch.float32
                                        else 1e-4))
    dys = torch.randn(ys.shape, generator=torch.Generator().manual_seed(N)
                      ).to(cuda, dtype)
    # both backwards from the same residuals
    dxp = lstm_cuda.lstm_backward_dxp(dys, xp, w, ys_p, cs_p, reverse)
    torch.cuda.synchronize()
    dxp_p = lstm.lstm_backward_dxp(dys, xp, w, ys_p, cs_p, reverse)
    assert dxp.dtype == dtype and dxp.shape == xp.shape
    assert bool(torch.isfinite(dxp.float()).all())
    assert _max_rel(dxp, dxp_p) <= rtol_dxp
    group = 64 if dtype == torch.bfloat16 else 256
    rows = lstm_cuda.group_rows("lstm_recurrence", dtype)
    assert (launches["lstm_forward_with_cells"],
            launches["lstm_backward_dxp"]) == (
        before[0] + -(-N // rows), before[1] + -(-N // group))


def test_trainable_recurrence_autograd_on_card(cuda):
    """LSTMRecurrence's gradients on the card match autograd through the
    plain recurrence (f32, relative to the largest element: 1e-3)."""
    T, N, H = 17, 8, 64
    xp, w = _lstm_inputs(T, N, H, seed=3, device=cuda, dtype=torch.float32)
    dy = torch.randn(T, N, H, generator=torch.Generator().manual_seed(4)
                     ).to(cuda)
    for reverse in (False, True):
        grads = []
        for fn in (lambda a, b: lstm_cuda.LSTMRecurrence.apply(a, b, reverse),
                   lambda a, b: lstm.lstm_recurrence(a, b, reverse)):
            a = xp.clone().requires_grad_()
            b = w.clone().requires_grad_()
            (fn(a, b) * dy).sum().backward()
            grads.append((a.grad, b.grad))
        for got, want in zip(*grads):
            assert _max_rel(got, want) <= 1e-3


_LOSS_WRAPPERS = ("forward_scan", "backward_scan", "edge_posteriors",
                  "lattice_forward", "lattice_backward")


def _loss_launches():
    return {k: launches[k] for k in _LOSS_WRAPPERS}


@pytest.mark.parametrize("n_base,state_len", [(6, 3), (4, 2)])
def test_loss_crf_kernels_match_plain(cuda, n_base, state_len):
    """K4 (alphas, logZ) and K5b (edge posteriors, with and without the
    cotangent) against their plain versions on the card."""
    T, N = 60, 5
    s = _scores(n_base, state_len, T, N, seed=2, device=cuda)
    before = _loss_launches()
    alphas, logz = crf_cuda.forward_scan(s, n_base, state_len)
    torch.cuda.synchronize()
    want = crf.forward_scores(s, n_base, state_len)
    want_z = crf.logz_from_alphas(want)
    torch.testing.assert_close(alphas, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logz, want_z, rtol=1e-5, atol=0)
    betas = crf.backward_scores(s, n_base, state_len)
    ct = torch.randn(N, generator=torch.Generator().manual_seed(3)).to(cuda)
    for c in (None, ct):
        post = crf_cuda.edge_posteriors(s, want, betas, want_z, c)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            post, crf.edge_posteriors(s, want, betas, want_z, c),
            rtol=1e-4, atol=1e-7)
    after = _loss_launches()
    assert after["forward_scan"] == before["forward_scan"] + 1
    assert after["edge_posteriors"] == before["edge_posteriors"] + 2


def _lattice_case(T, N, n, seed):
    """stay [T, N, n], move [T, N, n-1] and ct [N] from a seed on the card,
    and lengths [N] that differ (n, n-3, n/2, 1, at least 1)."""
    g = torch.Generator().manual_seed(seed)
    stay = torch.randn(T, N, n, generator=g).to("cuda")
    move = torch.randn(T, N, n - 1, generator=g).to("cuda")
    lengths = torch.tensor([n, n - 3, max(n // 2, 1), 1][:N]).clamp(min=1)
    ct = torch.randn(N, generator=g).to("cuda")
    return stay, move, lengths.to("cuda"), ct


def _lattice_against_plain(stay, move, lengths, ct):
    """K6a (alphas, logZ) and K6b (d_stay, d_move, from the plain alphas)
    held to their plain versions, one launch each; returns the kernels'
    outputs."""
    before = _loss_launches()
    alphas, logz = crf_cuda.lattice_forward(stay, move, lengths)
    torch.cuda.synchronize()
    want_a, want_z = crf.lattice_forward(stay, move, lengths)
    torch.testing.assert_close(alphas, want_a, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logz, want_z, rtol=1e-5, atol=0)
    d_stay, d_move = crf_cuda.lattice_backward(stay, move, lengths, want_a,
                                               want_z, ct)
    torch.cuda.synchronize()
    want_ds, want_dm = crf.lattice_backward(stay, move, lengths, want_a,
                                            want_z, ct)
    assert _max_rel(d_stay, want_ds) <= 1e-4
    if move.numel():
        assert _max_rel(d_move, want_dm) <= 1e-4
    after = _loss_launches()
    assert after["lattice_forward"] == before["lattice_forward"] + 1
    assert after["lattice_backward"] == before["lattice_backward"] + 1
    return alphas, logz, d_stay, d_move


# n: 1 and 2 (no move or one), 7 (narrower than a warp), 447-449 around the
# flagship's 448 (a packed row of n rounded up to 4), 1100 (wider than one
# block's 512 threads), 6144 (the widest, in a ring of 2 stages).  T: n + 40
# steps (None), or fewer than the ring's stages.
@pytest.mark.parametrize("n", [1, 2, 7, 447, 448, 449, 1100, 6144])
@pytest.mark.parametrize("T", [None, 1, 2, 7])
def test_lattice_kernels_match_plain(cuda, n, T):
    """K6a (alphas, logZ) and K6b (d_stay, d_move) against their plain
    versions, on rows whose lengths differ (one row of length 1)."""
    _lattice_against_plain(*_lattice_case(T or n + 40, 4, n, seed=n))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("above", [0, 1])
def test_lattice_kernels_at_the_edge_of_the_8_stage_ring(cuda, backward,
                                                         above):
    """At the widest lattice whose ring of K6a (or K6b) holds 8 stages in a
    block's shared memory, and one position wider (4 stages)."""
    widest = max(n for n in range(1, 6145)
                 if crf_cuda.lattice_depth(n, backward) == 8)
    n = widest + above
    assert crf_cuda.lattice_depth(n, backward) == (4 if above else 8)
    _lattice_against_plain(*_lattice_case(n + 40, 4, n, seed=n))


def _gathered_lattice(T=500, N=4, L=460, n_base=6, state_len=3):
    """stay and move as the loss gathers them (``prepare_ctc_scores``:
    non-contiguous slices of one [T, N, 2n-1] gather), the lattice lengths
    and a cotangent, on the card."""
    rng = np.random.default_rng(L)
    C = (n_base + 1) * n_base ** state_len
    s = torch.from_numpy(
        (np.tanh(rng.standard_normal((T, N, C))) * 5).astype(np.float32))
    lengths = np.array([L, L - 7, L // 2, state_len + 3][:N], np.int64)
    targets = np.zeros((N, L), np.int64)
    for i, k in enumerate(lengths):
        targets[i, :k] = rng.integers(1, n_base + 1, size=k)
    stay, move = crf.prepare_ctc_scores(
        s.to("cuda"), torch.from_numpy(targets).to("cuda"), n_base,
        state_len)
    ct = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    return (stay, move, torch.from_numpy(lengths + 1 - state_len).to("cuda"),
            ct.to("cuda"))


def test_lattice_kernels_take_the_loss_gather_slices(cuda):
    """The non-contiguous stay and move slices of the loss's gather give
    the alphas, logZ, d_stay and d_move of their contiguous copies bit for
    bit (both are packed), within tolerance of the plain versions."""
    stay, move, lengths, ct = _gathered_lattice()
    assert not stay.is_contiguous() and not move.is_contiguous()
    got = _lattice_against_plain(stay, move, lengths, ct)
    stay_c, move_c = stay.contiguous(), move.contiguous()
    alphas, logz = crf_cuda.lattice_forward(stay_c, move_c, lengths)
    want = (alphas, logz, *crf_cuda.lattice_backward(
        stay_c, move_c, lengths, got[0], got[1], ct))
    got = (*got[:2], *crf_cuda.lattice_backward(stay, move, lengths, got[0],
                                                got[1], ct))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ctc_lattice_logz_gradient_is_the_wrappers(cuda):
    """The gradient that ``ctc_loss`` takes through the lattice's logZ
    (``crf.ctc_lattice_logz``, which packs the gather's slices once for
    K6a and K6b) equals, bit for bit, d_stay and d_move of the wrappers on
    contiguous copies, and its logZ theirs."""
    stay, move, lengths, ct = _gathered_lattice()
    n = stay.shape[2]
    both = torch.cat([stay, move], 2).requires_grad_()
    before = _loss_launches()
    lz = crf.ctc_lattice_logz(both[:, :, :n], both[:, :, n:], lengths)
    lz.backward(ct)
    moved = {k: v - before[k] for k, v in _loss_launches().items()}
    assert moved["lattice_forward"] == moved["lattice_backward"] == 1
    stay_c, move_c = stay.contiguous(), move.contiguous()
    alphas, logz = crf_cuda.lattice_forward(stay_c, move_c, lengths)
    d_stay, d_move = crf_cuda.lattice_backward(stay_c, move_c, lengths,
                                               alphas, logz, ct)
    assert torch.equal(lz.detach(), logz)
    assert torch.equal(both.grad[:, :, :n], d_stay)
    assert torch.equal(both.grad[:, :, n:], d_move)


def test_lattice_kernels_refuse_wider_than_their_limit(cuda):
    T, N, n = 4, 2, 6145
    stay = torch.zeros(T, N, n, device=cuda)
    move = torch.zeros(T, N, n - 1, device=cuda)
    lengths = torch.full((N,), n, device=cuda)
    with pytest.raises(RuntimeError, match="6144"):
        crf_cuda.lattice_forward(stay, move, lengths)
    with pytest.raises(RuntimeError, match="6144"):
        crf_cuda.lattice_backward(stay, move, lengths, stay,
                                  torch.zeros(N, device=cuda),
                                  torch.ones(N, device=cuda))


@pytest.mark.parametrize("alphabet,state_len", [("NACGTXY", 3), ("NACGT", 2)])
def test_ctc_loss_through_kernels_matches_plain_path(cuda, alphabet,
                                                     state_len):
    """crf.ctc_loss and its gradient with respect to the scores: through
    the five loss kernels on the card, the plain path on the CPU.  Without
    gradients only K4 and K6a run."""
    n_base, T, N, L = len(alphabet) - 1, 120, 4, 40
    rng = np.random.default_rng(state_len)
    C = (n_base + 1) * n_base ** state_len
    s = (np.tanh(rng.standard_normal((T, N, C))) * 5).astype(np.float32)
    lengths = np.array([L, L - 7, L - 1, state_len + 3], np.int64)
    targets = np.zeros((N, L), np.int64)
    for i, k in enumerate(lengths):
        targets[i, :k] = rng.integers(1, n_base + 1, size=k)
    out = {}
    for dev in ("cuda", "cpu"):
        x = torch.from_numpy(s).to(dev).requires_grad_()
        before = _loss_launches()
        loss = crf.ctc_loss(x, torch.from_numpy(targets).to(dev),
                            torch.from_numpy(lengths).to(dev), n_base,
                            state_len)
        loss.backward()
        moved = {k: v - before[k] for k, v in _loss_launches().items()}
        out[dev] = (loss.item(), x.grad.cpu(), moved)
    assert out["cuda"][2] == dict.fromkeys(_LOSS_WRAPPERS, 1)
    assert out["cpu"][2] == dict.fromkeys(_LOSS_WRAPPERS, 0)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    assert _max_rel(out["cuda"][1], out["cpu"][1]) <= 1e-4
    before = _loss_launches()
    with torch.no_grad():
        crf.ctc_loss(torch.from_numpy(s).to(cuda),
                     torch.from_numpy(targets).to(cuda),
                     torch.from_numpy(lengths).to(cuda), n_base, state_len)
    moved = {k: v - before[k] for k, v in _loss_launches().items()}
    assert moved == {"forward_scan": 1, "backward_scan": 0,
                     "edge_posteriors": 0, "lattice_forward": 1,
                     "lattice_backward": 0}


def test_ensemble_of_one_model_twice_calls_as_the_model(cuda):
    """A checkpoint ensemble [m, m] on the card calls what m calls: the
    mean of two equal f32 score tensors is the tensor, and K1 (here at 130
    rows, the wgmma kernel) gives the same bits at every call."""
    from xna_basecaller_tpu_torch.core.config import (
        EncoderConfig, ModelConfig,
    )
    from xna_basecaller_tpu_torch.data.simulate import simulate_reads
    from xna_basecaller_tpu_torch.infer.basecall import basecall
    from xna_basecaller_tpu_torch.models.crf_model import Model

    cfg = ModelConfig(encoder=EncoderConfig(features=768, num_rnn_layers=2))
    model = Model(cfg, device=cuda, seed=3).eval()
    reads = list(simulate_reads(12, mean_len=36000, seed=2))

    def calls(members):
        return [a["sequence"] for _, a in basecall(
            members, iter(reads), chunksize=3600, overlap=500,
            batchsize=130)]
    alone = calls(model)
    assert len(alone) == len(reads)
    assert calls([model, model]) == alone


# The q-score variants of K2b and K2c (forward_viterbi_qual,
# viterbi_traceback_qual), and the beam kernel (beam_search).

def _qual_launches():
    return (launches["forward_viterbi_qual"],
            launches["viterbi_traceback_qual"])


@pytest.mark.parametrize("n_base,state_len", _RING_ALPHABETS)
@pytest.mark.parametrize("N", [1, 75, 256])
@pytest.mark.parametrize("T", _RING_T + [720])
def test_qual_decode_kernels_match_plain(cuda, T, N, n_base, state_len):
    """The q-score K2b on the same scores, betas and logZ as the Viterbi
    K2b: backpointers and v_final bit-equal to its (the flag adds a store
    and changes no operation).  Its edge_sel within 4 ulps of |logZ| (at
    least 1e-5) of the plain version's where their backpointers agree: the
    edge sums alpha, the score, beta and -logZ, terms as large as |logZ|,
    whose last bits the two versions' alphas round differently (one ulp,
    9.8e-4 at |logZ| ~ 8000, seen at T=720).  The q-score K2c: labels
    bit-equal to the Viterbi K2c's on the same bp and v_final, probs
    within 1e-6 of the plain version's on the same bp, v_final and
    edge_sel (one expf each); one launch each."""
    s = _card_scores(n_base, state_len, T, N, seed=T * 1000 + N + 11)
    betas, logz = _viterbi_inputs(s, n_base, state_len)
    before = _qual_launches()
    bp, v, edge_sel = crf_cuda.forward_viterbi_qual(s, betas, logz, n_base,
                                                    state_len)
    labels, probs = crf_cuda.viterbi_traceback_qual(bp, v, edge_sel, n_base,
                                                    state_len)
    torch.cuda.synchronize()
    assert _qual_launches() == (before[0] + 1, before[1] + 1)
    bp_v, v_v = crf_cuda.forward_viterbi(s, betas, logz, n_base, state_len)
    assert torch.equal(bp, bp_v) and torch.equal(v, v_v)
    assert torch.equal(labels, crf_cuda.viterbi_traceback(
        bp, v, n_base, state_len))
    bp_p, _, edge_p = crf.forward_viterbi(s, betas, logz, n_base,
                                          state_len, qual=True)
    agree = bp == bp_p
    assert agree.float().mean().item() >= 1 - 1e-3
    ulp = 2.0 ** (math.floor(math.log2(logz.abs().max().item())) - 23)
    torch.testing.assert_close(edge_sel[agree], edge_p[agree], rtol=0,
                               atol=max(1e-5, 4 * ulp))
    labels_p, probs_p = crf.viterbi_traceback(bp, v, n_base, state_len,
                                              edge_sel)
    assert torch.equal(labels, labels_p)
    assert probs.dtype == torch.float32 and probs.shape == (N, T)
    torch.testing.assert_close(probs, probs_p, rtol=0, atol=1e-6)


def test_qual_decode_chain_labels_are_the_viterbi_decodes(cuda):
    """decode_paths_with_qual_cuda: K2a, K2b-qual and K2c-qual once each,
    labels bit-equal to decode_paths_cuda's, probs in (0, 1]."""
    s = _card_scores(6, 3, 300, 64, seed=5)
    before = (launches["backward_scan"], *_qual_launches())
    labels, probs = crf_cuda.decode_paths_with_qual_cuda(s, 6, 3)
    torch.cuda.synchronize()
    assert (launches["backward_scan"], *_qual_launches()) == tuple(
        b + 1 for b in before)
    assert torch.equal(labels, crf_cuda.decode_paths_cuda(s, 6, 3))
    assert bool(((probs > 0) & (probs <= 1 + 1e-5)).all())


# Beam widths: 1; 2 and 8; 32 (past a warp of candidates at 6 bases); 128
# (JAX's tests) and 256, the widest the kernel takes.  Alphabets: (2, 1)
# has 6 edges, fewer than most widths (JAX's padding, dead beams); (5, 3)
# and (7, 2) read device memory directly (rows not multiples of 16 bytes),
# the others take the ring.
_BEAM_B = [1, 2, 8, 32, 128, 256]
_BEAM_ALPHABETS = [(2, 1), (4, 2), (4, 3), (5, 3), (6, 3), (7, 2)]


def _beam_inputs(s, n_base, state_len):
    alphas, logz = crf_cuda.forward_scan(s, n_base, state_len)
    betas = crf_cuda.backward_scan(s, n_base, state_len)
    return alphas, betas, logz


def _hold_beam_to_plain(got, s, parts, n_base, state_len, B):
    """The beam kernel's (labels, best_score) against the plain version's
    on the same scores and partials: best_score within 1e-4 (rtol 1e-6) in
    every row (the merge's log-sum-exp of 3 or more candidates adds in
    another order); labels equal in every row whose winner leads the best
    other sequence by more than 1e-4 (a nearer tie may go either way), and
    such near ties in at most one row in 16 (one at least), so that the
    exemption cannot cover a kernel wrong in many rows."""
    labels, best = got
    want, want_best, merged, winner = crf._beam_search(
        s, *parts, n_base, state_len, B)
    assert labels.dtype == torch.int8 and labels.shape == want.shape
    torch.testing.assert_close(best, want_best, rtol=1e-6, atol=1e-4)
    gap = want_best - torch.where(winner, -1e38, merged).amax(-1)
    clear = gap > 1e-4
    assert int((~clear).sum()) <= max(1, len(gap) // 16)
    assert torch.equal(labels[clear], want[clear])


@pytest.mark.parametrize("B", _BEAM_B)
@pytest.mark.parametrize("n_base,state_len", _BEAM_ALPHABETS)
@pytest.mark.parametrize("T,N", [(1, 3), (2, 5), (9, 4), (40, 3)])
def test_beam_kernel_matches_plain(cuda, T, N, n_base, state_len, B):
    s = _card_scores(n_base, state_len, T, N, seed=T * 100 + N + B)
    parts = _beam_inputs(s, n_base, state_len)
    before = launches["beam_search"]
    got = crf_cuda.beam_search(s, *parts, n_base, state_len, B)
    torch.cuda.synchronize()
    assert launches["beam_search"] == before + 1
    _hold_beam_to_plain(got, s, parts, n_base, state_len, B)


@pytest.mark.parametrize("B", [1, 8, 32])
def test_beam_kernel_at_the_basecall_batch(cuda, B):
    """The flagship's alphabet at T=720 and 256 rows, through the ring."""
    s = _card_scores(6, 3, 720, 256, seed=B)
    parts = _beam_inputs(s, 6, 3)
    got = crf_cuda.beam_search(s, *parts, 6, 3, B)
    _hold_beam_to_plain(got, s, parts, 6, 3, B)


@pytest.mark.parametrize("n_base,state_len", [(4, 2), (6, 3)])
def test_beam_kernel_takes_rows_at_any_alignment(cuda, n_base, state_len):
    """Scores that start 4 bytes into their allocation read device memory
    directly: labels and best_score bit-equal to the ring's on the same
    values 16-byte aligned."""
    s = _card_scores(n_base, state_len, 40, 9, seed=3, offset=1)
    aligned = s.clone()
    parts = _beam_inputs(aligned, n_base, state_len)
    for B in (1, 8, 64):
        got = crf_cuda.beam_search(s, *parts, n_base, state_len, B)
        want = crf_cuda.beam_search(aligned, *parts, n_base, state_len, B)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_beam_decode_chain_runs_its_kernels(cuda):
    """decode_beam_cuda: K4, K2a and the beam kernel once each, no K2b or
    K2c; a width past the kernel's limit raises, naming it."""
    s = _card_scores(6, 3, 100, 16, seed=9)
    names = ("forward_scan", "backward_scan", "beam_search",
             "forward_viterbi", "viterbi_traceback")
    before = {k: launches[k] for k in names}
    labels, best = crf_cuda.decode_beam_cuda(s, 6, 3, 8)
    torch.cuda.synchronize()
    moved = {k: launches[k] - before[k] for k in names}
    assert moved == {"forward_scan": 1, "backward_scan": 1,
                     "beam_search": 1, "forward_viterbi": 0,
                     "viterbi_traceback": 0}
    _hold_beam_to_plain((labels, best), s, _beam_inputs(s, 6, 3), 6, 3, 8)
    with pytest.raises(ValueError, match=str(crf_cuda.MAX_BEAM_WIDTH)):
        crf_cuda.decode_beam_cuda(s, 6, 3, crf_cuda.MAX_BEAM_WIDTH + 1)


# The CRF head's epilogue (ops/crf_head.py): the kernel against the chain
# of PyTorch passes on the card, bit for bit.

def _head_product(T, N, C, dtype, seed, offset=0):
    """A product [T, N, C] and a bias [C] made on the card, with large |x|
    among them where tanh saturates; the product starts ``offset``
    elements into its allocation."""
    g = torch.Generator("cuda").manual_seed(seed)
    flat = torch.randn(offset + T * N * C, device="cuda", generator=g) * 3
    flat[::17] *= 40
    b = torch.randn(C, device="cuda", generator=g)
    b[::5] *= 30
    return flat.to(dtype)[offset:].view(T, N, C), b.to(dtype)


# (n_base, C) of the three basecall cells' heads: the XNA model (NACGTXY,
# state_len 3), ONT's hac (NACGT, 4) and ONT's R10.4.1 sup (NACGT, 5); 37 x
# 13 rows, no multiple of a block's 256 units or of a warp's 32
_HEAD_SHAPES = [(6, 1296), (4, 1024), (4, 4096)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("scale,blank", [(5.0, 2.0), (5.0, None),
                                         (None, 2.0)])
@pytest.mark.parametrize("n_base,C", _HEAD_SHAPES)
def test_crf_head_kernel_is_bit_equal_to_the_chain(cuda, n_base, C, scale,
                                                   blank, dtype):
    from xna_basecaller_tpu_torch.ops import crf_head

    p, b = _head_product(37, 13, C, dtype, seed=C + n_base)
    k = crf_head.crf_head_epilogue
    before = launches["crf_head_epilogue"]
    tiled = launches["crf_head_epilogue.tiled"]
    got = k(p, b, scale, blank, n_base)
    torch.cuda.synchronize()
    assert launches["crf_head_epilogue"] == before + 1
    # without a blank score the plain loop (no cell runs one)
    assert launches["crf_head_epilogue.tiled"] \
        == tiled + (blank is not None)
    want = crf_head.crf_head_chain(p, b, scale, blank, n_base)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_base,C,offset", [
    (5, 3125, 0),     # NACGTX at state_len 4: n_base 5 takes the plain loop
    (6, 36, 0),       # NACGTXY at state_len 1: rows of fewer than a unit
    (4, 1024, 1),     # a product 2 bytes into its allocation
])
def test_crf_head_kernel_other_shapes_take_its_plain_loop(cuda, n_base, C,
                                                          offset):
    from xna_basecaller_tpu_torch.ops import crf_head

    p, b = _head_product(21, 11, C, torch.bfloat16, seed=C, offset=offset)
    k = crf_head.crf_head_epilogue
    before = launches["crf_head_epilogue"]
    tiled = launches["crf_head_epilogue.tiled"]
    got = k(p, b, 5.0, 2.0, n_base)
    assert launches["crf_head_epilogue"] == before + 1
    assert launches["crf_head_epilogue.tiled"] == tiled
    assert torch.equal(got, crf_head.crf_head_chain(p, b, 5.0, 2.0, n_base))


def test_crf_head_kernel_takes_an_f32_product_with_a_bf16_bias(cuda):
    """The int8 head's case: the product f32, the bias in x's dtype."""
    from xna_basecaller_tpu_torch.ops import crf_head

    p, _ = _head_product(9, 7, 4096, torch.float32, seed=4)
    _, b = _head_product(1, 1, 4096, torch.bfloat16, seed=5)
    tiled = launches["crf_head_epilogue.tiled"]
    got = crf_head.crf_head_epilogue(p, b, 5.0, 2.0, 4)
    assert launches["crf_head_epilogue.tiled"] == tiled + 1
    assert torch.equal(got, crf_head.crf_head_chain(p, b, 5.0, 2.0, 4))


@pytest.mark.parametrize("p_dtype,b_dtype", [
    (torch.float64, torch.float64), (torch.bfloat16, torch.float32),
    (torch.float16, torch.bfloat16)])
def test_crf_head_kernel_raises_for_other_dtypes(cuda, p_dtype, b_dtype):
    from xna_basecaller_tpu_torch.ops import crf_head

    p = torch.zeros(4, 3, 1024, dtype=p_dtype, device=cuda)
    b = torch.zeros(1024, dtype=b_dtype, device=cuda)
    with pytest.raises(ValueError, match="bf16, f16 or f32"):
        crf_head.crf_head_epilogue(p, b, 5.0, 2.0, 4)


def test_model_forward_launches_the_head_kernel_in_inference_only(cuda):
    """One launch a bf16 inference forward, scores bit-equal to the chain's
    (the same head with grad on takes the chain); none in the training
    forward; one an f32 or int8 inference forward."""
    from xna_basecaller_tpu_torch.core.config import (
        EncoderConfig, ModelConfig,
    )
    from xna_basecaller_tpu_torch.models.crf_model import (
        Model, crf_head_forward,
    )
    from xna_basecaller_tpu_torch.ops import crf_head

    cfg = ModelConfig(encoder=EncoderConfig(features=64, num_rnn_layers=2))
    model = Model(cfg, device=cuda, seed=2)
    sig = torch.randn(6, 1800, device=cuda,
                      generator=torch.Generator("cuda").manual_seed(3))
    k = crf_head.crf_head_epilogue
    before = launches["crf_head_epilogue"]
    with torch.inference_mode():
        scores = model(sig)
    assert launches["crf_head_epilogue"] == before + 1
    assert scores.shape == (360, 6, cfg.n_score)
    x = torch.randn(50, 6, 64, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        fused = crf_head_forward(model.head, model.head_ext, x, cfg)
    chain = crf_head_forward(model.head, model.head_ext, x, cfg)
    assert chain.requires_grad and launches["crf_head_epilogue"] == before + 2
    assert torch.equal(fused, chain.detach())
    model(sig, inference=False).sum().backward()
    torch.cuda.synchronize()
    assert launches["crf_head_epilogue"] == before + 2
    assert model.head.w.grad is not None and model.head.b.grad is not None
    # f32 inference (duplex --pair-decode) and the int8 head take it too
    with torch.inference_mode():
        f32 = crf_head_forward(model.head, model.head_ext, x.float(), cfg)
        crf_head_forward(model.head, model.head_ext, x, cfg, int8=True)
    assert launches["crf_head_epilogue"] == before + 4
    f32_chain = crf_head_forward(model.head, model.head_ext, x.float(), cfg)
    assert launches["crf_head_epilogue"] == before + 4
    assert torch.equal(f32, f32_chain.detach())
