"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Marked ``gpu``; each test skips where there is no CUDA device.

Run them on a machine with the card:
    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Tolerances: f32 LSTM 1e-4 (the same math summed in another order over the
steps); bf16 LSTM 2e-2 absolute (a few bf16 ulps of |h| < 1, where an f32
ordering difference flips a rounding of h); betas and logZ rtol 1e-5;
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
