"""The port's trainable LSTM (plain versions of K3a and K3b, CPU) against
the JAX package's ``lstm_forward_pallas_trainable`` with its Pallas
kernels in interpret mode.

Tolerances: f32 values and gradients rtol 2e-3, atol 2e-4 (the bound of
the JAX package's own test of the same function, ``test_pallas.py:108``;
they agree far closer); bf16 5e-2 absolute on ys and 5e-2 relative to the
largest element on the gradients (both sides keep the cell residuals in
bf16, the JAX default, and round the input projection at different
places: a few bf16 ulps).  The analytic backward against autograd through
the plain recurrence: f32, 1e-5 relative to the largest element.
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


def _case(T, N, insize, H, seed):
    p = jlstm.init_lstm_params(jax.random.key(seed), insize, H)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, insize)).astype(np.float32)
    dy = rng.standard_normal((T, N, H)).astype(np.float32)
    return p, x, dy


def _jax_grads(p, x, dy, reverse, dtype=jnp.float32):
    def loss(params, x):
        params = jax.tree.map(lambda a: a.astype(dtype), params)
        y = lstm_pallas.lstm_forward_pallas_trainable(
            params, x.astype(dtype), reverse=reverse)
        return jnp.sum(y.astype(jnp.float32) * dy), y
    (_, y), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    return (np.asarray(y.astype(jnp.float32)),
            {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx))


def _port_grads(p, x, dy, reverse, dtype=torch.float32):
    params = {k: torch.from_numpy(np.array(v)).requires_grad_()
              for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = lstm_cuda.lstm_forward_trainable(
        {k: v.to(dtype) for k, v in params.items()}, xt.to(dtype), reverse)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    return (y.detach().float().numpy(),
            {k: v.grad.numpy() for k, v in params.items()}, xt.grad.numpy())


@pytest.mark.parametrize("T,N", [(10, 3), (9, 4)])   # 9: an odd T
@pytest.mark.parametrize("reverse", [False, True])
def test_trainable_lstm_f32_matches_jax(pallas_interpret, T, N, reverse):
    p, x, dy = _case(T, N, 24, 32, seed=T + N)
    y_j, gp_j, gx_j = _jax_grads(p, x, dy, reverse)
    y_p, gp_p, gx_p = _port_grads(p, x, dy, reverse)
    np.testing.assert_allclose(y_p, y_j, rtol=2e-3, atol=2e-4)
    for k in ("w_ih", "w_hh", "bias"):
        np.testing.assert_allclose(gp_p[k], gp_j[k], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(gx_p, gx_j, rtol=2e-3, atol=2e-4)


def test_trainable_lstm_bf16_matches_jax(pallas_interpret):
    """bf16 with the JAX default bf16 cell residuals."""
    assert lstm_pallas._CELL_RESID_COMPUTE_DTYPE
    p, x, dy = _case(12, 5, 32, 32, seed=11)
    for reverse in (False, True):
        y_j, gp_j, gx_j = _jax_grads(p, x, dy, reverse, jnp.bfloat16)
        y_p, gp_p, gx_p = _port_grads(p, x, dy, reverse, torch.bfloat16)
        np.testing.assert_allclose(y_p, y_j, atol=5e-2)
        for got, want in [(gp_p[k], gp_j[k]) for k in gp_j] + [(gx_p, gx_j)]:
            assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("reverse", [False, True])
def test_analytic_backward_matches_autograd(reverse):
    """The plain K3b equals autograd through the plain recurrence."""
    g = torch.Generator().manual_seed(5)
    T, N, H = 11, 3, 16
    xp = torch.randn(T, N, 4 * H, generator=g)
    w = torch.randn(H, 4 * H, generator=g) / H ** 0.5
    dy = torch.randn(T, N, H, generator=g)
    grads = []
    for fn in (lambda a, b: lstm_cuda.LSTMRecurrence.apply(a, b, reverse),
               lambda a, b: lstm.lstm_recurrence(a, b, reverse)):
        a, b = xp.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(a, b) * dy).sum().backward()
        grads.append((a.grad, b.grad))
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors K3a and K3b are their plain versions and launch
    nothing; K3a's ys are K1's."""
    g = torch.Generator().manual_seed(6)
    xp = torch.randn(7, 2, 64, generator=g)
    w = torch.randn(16, 64, generator=g) / 4
    before = (launches["lstm_forward_with_cells"],
              launches["lstm_backward_dxp"])
    for reverse in (False, True):
        ys, cs = lstm_cuda.lstm_forward_with_cells(xp, w, reverse)
        ys_p, cs_p = lstm.lstm_recurrence_with_cells(xp, w, reverse)
        torch.testing.assert_close(ys, ys_p, rtol=0, atol=0)
        torch.testing.assert_close(cs, cs_p, rtol=0, atol=0)
        torch.testing.assert_close(ys, lstm.lstm_recurrence(xp, w, reverse),
                                   rtol=0, atol=0)
        dy = torch.randn(ys.shape, generator=g)
        torch.testing.assert_close(
            lstm_cuda.lstm_backward_dxp(dy, xp, w, ys, cs, reverse),
            lstm.lstm_backward_dxp(dy, xp, w, ys, cs, reverse),
            rtol=0, atol=0)
    assert (launches["lstm_forward_with_cells"],
            launches["lstm_backward_dxp"]) == before


def test_cells_are_stored_in_the_compute_dtype():
    xp = torch.randn(5, 2, 32).to(torch.bfloat16)
    w = (torch.randn(8, 32) / 3).to(torch.bfloat16)
    ys, cs = lstm.lstm_recurrence_with_cells(xp, w)
    assert ys.dtype == cs.dtype == torch.bfloat16
