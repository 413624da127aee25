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
the f32 near-ties that the decode tests of chip_smoke.py count.
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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
# 130 rows: a second, 2-row batch tile; H=96: a part-width h chunk;
# 300 rows: two launches (at most 256 rows each)
@pytest.mark.parametrize("N,H", [(16, 64), (5, 64), (130, 96), (300, 64)])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_kernel_matches_plain(cuda, dtype, atol, N, H, reverse):
    xp, w = _lstm_inputs(40, N, H, seed=N, device=cuda, dtype=dtype)
    before = lstm_cuda.lstm_recurrence.launches
    got = lstm_cuda.lstm_recurrence(xp, w, reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_recurrence.launches == before + -(-N // 256)
    want = lstm.lstm_recurrence(xp, w, reverse)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


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


def _max_rel(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype,atol,rtol_dxp", [(torch.float32, 1e-4, 1e-3),
                                                 (torch.bfloat16, 5e-2, 5e-2)])
# 64: the training batch; 100: a second, part-filled row tile
@pytest.mark.parametrize("N", [64, 100])
@pytest.mark.parametrize("reverse", [False, True])
def test_trainable_lstm_kernels_match_plain(cuda, dtype, atol, rtol_dxp, N,
                                            reverse):
    """K3a (ys and cells) and K3b (dxp) against their plain versions."""
    T, H = 33, 96
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
    group = 128 if dtype == torch.bfloat16 else 256
    assert (lstm_cuda.lstm_forward_with_cells.launches,
            lstm_cuda.lstm_backward_dxp.launches) == (
        before[0] + 1, before[1] + -(-N // group))


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
