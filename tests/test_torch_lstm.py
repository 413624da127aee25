"""Port LSTM (plain PyTorch, CPU) against the JAX package.

The port's recurrence follows the Pallas kernel's numerics (f32 gate add,
hidden state in xp's dtype), so it is held against ``lstm_forward_pallas``
run in interpret mode, and in f32 also against the XLA scan
(``ops/lstm.lstm_forward``).  f32: 1e-5.  bf16: 2e-2 absolute, a few bf16
ulps of |h| < 1 — the two sides round the input projection at different
places (torch rounds x @ w_ih to bf16 before the bias add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.ops import lstm as jlstm
from xna_basecaller_tpu.ops import lstm_pallas
from xna_basecaller_tpu_torch.ops import lstm, lstm_cuda
from xna_basecaller_tpu_torch.ops._build import launches


@pytest.fixture()
def pallas_interpret(monkeypatch):
    """Run every pl.pallas_call in interpret mode (as test_pallas.py does)."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _params(H, insize, seed):
    p = jlstm.init_lstm_params(jax.random.key(seed), insize, H)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("N", [4, 3])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_forward_f32_matches_jax(pallas_interpret, N, reverse):
    H, T = 64, 12
    p_jax, p_t = _params(H, 48, seed=N)
    x = np.random.default_rng(N).standard_normal((T, N, 48)).astype(
        np.float32)
    y_pal = np.asarray(lstm_pallas.lstm_forward_pallas(
        p_jax, jnp.asarray(x), reverse=reverse))
    y_scan = np.asarray(jlstm.lstm_forward(p_jax, jnp.asarray(x),
                                           reverse=reverse))
    # the port's layer (dispatches to the plain recurrence on the CPU)
    y_port = lstm_cuda.lstm_forward(p_t, torch.from_numpy(x),
                                    reverse=reverse).numpy()
    np.testing.assert_allclose(y_port, y_pal, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_port, y_scan, rtol=1e-5, atol=1e-5)


def test_lstm_recurrence_bf16_matches_pallas(pallas_interpret):
    H, T, N = 32, 16, 5
    p_jax, p_t = _params(H, H, seed=7)
    x = np.random.default_rng(7).standard_normal((T, N, H)).astype(
        np.float32)
    pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p_jax)
    for reverse in (False, True):
        y_pal = np.asarray(lstm_pallas.lstm_forward_pallas(
            pj, jnp.asarray(x, jnp.bfloat16), reverse=reverse
        ).astype(jnp.float32))
        y_port = lstm_cuda.lstm_forward(
            {k: v.to(torch.bfloat16) for k, v in p_t.items()},
            torch.from_numpy(x).to(torch.bfloat16), reverse=reverse)
        assert y_port.dtype == torch.bfloat16
        np.testing.assert_allclose(y_port.float().numpy(), y_pal, atol=2e-2)


def test_recurrence_plain_equals_wrapper_on_cpu():
    """On a CPU tensor the wrapper is the plain version, and launches
    nothing."""
    rng = np.random.default_rng(3)
    xp = torch.from_numpy(rng.standard_normal((6, 2, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    before = launches["lstm_recurrence"]
    for reverse in (False, True):
        torch.testing.assert_close(
            lstm_cuda.lstm_recurrence(xp, w, reverse),
            lstm.lstm_recurrence(xp, w, reverse), rtol=0, atol=0)
    assert launches["lstm_recurrence"] == before


def test_reverse_is_flip_of_forward():
    rng = np.random.default_rng(4)
    xp = torch.from_numpy(rng.standard_normal((9, 3, 128)).astype(np.float32))
    w = torch.from_numpy(
        0.1 * rng.standard_normal((32, 128)).astype(np.float32))
    y_rev = lstm.lstm_recurrence(xp, w, reverse=True)
    y_flip = lstm.lstm_recurrence(xp.flip(0), w).flip(0)
    torch.testing.assert_close(y_rev, y_flip, rtol=0, atol=0)
