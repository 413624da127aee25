"""Port model (CPU) against the JAX model: weights carried across with
``params_from_jax``, scores compared in f32 (2e-5: five LSTM layers of f32
roundings in another order), plus a ``weights_N.npz`` round trip through
the port's ``load_model``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu.models import crf_model as jmodel
from xna_basecaller_tpu.train import checkpoint as ckpt
from xna_basecaller_tpu_torch.core import config as tconfig
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.utils.model_io import load_model
from xna_basecaller_tpu_torch.utils.weights import params_from_jax


def _cfg(**enc):
    return ModelConfig(encoder=EncoderConfig(
        features=enc.pop("features", 32), num_rnn_layers=enc.pop("layers", 2),
        **enc))


def _port_cfg(cfg):
    return tconfig.from_dict(jconfig.to_dict(cfg))


@pytest.mark.parametrize("enc", [
    {}, {"layers": 3, "features": 48}, {"extra_linear": True}])
def test_forward_f32_matches_jax(enc):
    cfg = _cfg(**enc)
    params = jmodel.init_params(jax.random.key(0), cfg)
    sig = np.random.default_rng(1).standard_normal((3, 600)).astype(
        np.float32)
    want = np.asarray(jmodel.forward(params, jnp.asarray(sig), cfg,
                                     compute_dtype=jnp.float32,
                                     inference=False))
    model = Model(_port_cfg(cfg), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(sig), compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (120, 3, cfg.n_score)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_forward_bf16_close_to_jax():
    """bf16 LSTMs and head on both sides: a stated 0.25 absolute tolerance
    on scores in [-5, 5] (each side rounds to bf16 at its own places,
    and the XLA scan rounds h @ W_hh too)."""
    cfg = _cfg()
    params = jmodel.init_params(jax.random.key(2), cfg)
    sig = np.random.default_rng(3).standard_normal((2, 400)).astype(
        np.float32)
    want = np.asarray(jmodel.forward(params, jnp.asarray(sig), cfg,
                                     compute_dtype=jnp.bfloat16,
                                     inference=False))
    model = Model(_port_cfg(cfg), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(sig)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.25)


def test_load_model_reads_jax_checkpoint(tmp_path):
    cfg = _cfg()
    params = jmodel.init_params(jax.random.key(4), cfg)
    jconfig.save(cfg, str(tmp_path))
    ckpt.save_checkpoint(str(tmp_path), 3, params)
    model, tcfg = load_model(str(tmp_path), device="cpu", chunksize=999,
                             batchsize=7)
    assert tcfg.package == "xna_basecaller_tpu.models.crf_model"
    assert tcfg.basecaller.chunksize == 999
    assert tcfg.basecaller.batchsize == 7
    assert tcfg.basecaller.overlap == 500
    state = model.state_dict()
    np.testing.assert_array_equal(
        state["conv.2.weight"].numpy(),
        np.asarray(params["conv"][2]["w"]).transpose(2, 1, 0))
    for i, layer in enumerate(params["rnn"]):
        for k in ("w_ih", "w_hh", "bias"):
            np.testing.assert_array_equal(state[f"rnn.{i}.{k}"].numpy(),
                                          np.asarray(layer[k]))
    np.testing.assert_array_equal(state["head.w"].numpy(),
                                  np.asarray(params["head"]["w"]))
    # the flat npz and the tree carry across to the same state_dict
    with np.load(tmp_path / "weights_3.npz") as npz:
        flat = params_from_jax({k: npz[k] for k in npz.files})
    tree = params_from_jax(params)
    assert flat.keys() == tree.keys()
    for k in flat:
        torch.testing.assert_close(flat[k], tree[k], rtol=0, atol=0)


def test_random_init_is_seeded():
    cfg = _port_cfg(_cfg())
    a = Model(cfg, device="cpu", seed=5).state_dict()
    b = Model(cfg, device="cpu", seed=5).state_dict()
    c = Model(cfg, device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["rnn.0.w_hh"], c["rnn.0.w_hh"])
    # per-gate orthogonal recurrent weights, as the JAX init draws them
    w = a["rnn.0.w_hh"][:, :32]
    torch.testing.assert_close(w.T @ w, torch.eye(32), rtol=0, atol=1e-5)
