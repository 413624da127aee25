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
differ).
"""

import numpy as np
import pytest
import torch

from xna_basecaller_tpu_torch.ops import crf, crf_cuda, lstm, lstm_cuda

pytestmark = pytest.mark.gpu


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


# Batch sizes and widths of the launch geometry: 1, 5, 16 and 64 rows take
# the bf16 cluster path (N <= 64); 65 up to 256 one launch of the rows
# kernel: 65, 127 and 128 one tile of 128 rows (65: one row in the last
# 16-row block), 129 and 130 a second tile of 1 or 2 rows, 200 a second
# tile of 72 rows, 255 and 256 two tiles; 257 and 300 two launches (at most
# 256 rows each), the second of 1 or 44 rows on the cluster path.  H=96: a
# part-width h chunk; H=768 the flagship width, at T=300 for N=64 and
# N=256 (a lost flag or a missing fence shows as rare wrong values only over
# many steps).
_LSTM_N = [1, 5, 16, 64, 65, 127, 128, 129, 130, 200, 255, 256, 257, 300]
_LSTM_H = [64, 96, 768]


def _steps(N, H, T):
    return 300 if (N, H) in ((64, 768), (256, 768)) else T


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N", _LSTM_N)
@pytest.mark.parametrize("H", _LSTM_H)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_kernel_matches_plain(cuda, dtype, atol, N, H, reverse):
    xp, w = _lstm_inputs(_steps(N, H, 40), N, H, seed=N, device=cuda,
                         dtype=dtype)
    before = lstm_cuda.lstm_recurrence.launches
    got = lstm_cuda.lstm_recurrence(xp, w, reverse)
    torch.cuda.synchronize()
    group = lstm_cuda.group_rows("lstm_recurrence")
    assert lstm_cuda.lstm_recurrence.launches == before + -(-N // group)
    want = lstm.lstm_recurrence(xp, w, reverse)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


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
    before = lstm_cuda.lstm_recurrence_int8.launches
    got = lstm_cuda.lstm_recurrence_int8(xp, w_q, scale, reverse)
    torch.cuda.synchronize()
    group = lstm_cuda.group_rows("lstm_int8")
    assert lstm_cuda.lstm_recurrence_int8.launches == before + -(-N // group)
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
    return (crf_cuda.backward_scan.launches, crf_cuda.forward_scan.launches)


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
    before = (lstm_cuda.lstm_forward_with_cells.launches,
              lstm_cuda.lstm_backward_dxp.launches)
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
    rows = lstm_cuda.group_rows("lstm_recurrence")
    assert (lstm_cuda.lstm_forward_with_cells.launches,
            lstm_cuda.lstm_backward_dxp.launches) == (
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
    return {k: getattr(crf_cuda, k).launches for k in _LOSS_WRAPPERS}


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
