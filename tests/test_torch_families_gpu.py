"""The QuartzNet CTC family, the mods classifier and duplex's transition
posteriors on the card against the port's CPU run (the CPU runs are held
to the JAX package in tests/test_torch_{ctc,mods,duplex}.py).  Marked
``gpu``; each test skips where there is no CUDA device.

Run them on a machine with the card:
    python -m pytest tests/test_torch_families_gpu.py -m gpu --noconftest

Tolerances (f32 on both sides, TF32 off; cuDNN's and the CPU's
convolutions sum in other orders): QuartzNet log-probs rtol 1e-4 and
atol 1e-4, and the loss of one train_step rtol 1e-4; the mods logits
rtol and atol 1e-5; the transition posteriors atol 1e-4 (K1's f32 route
and K2a against their plain versions).
"""

import os

import numpy as np
import pytest
import torch

from xna_basecaller_tpu_torch.core import config as config_lib
from xna_basecaller_tpu_torch.core.config import (
    BlockConfig, EncoderConfig, ModelConfig,
)
from xna_basecaller_tpu_torch.infer import pair_decode
from xna_basecaller_tpu_torch.models import ctc_model
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.mods import model as mods_model
from xna_basecaller_tpu_torch.train import checkpoint as ckpt
from xna_basecaller_tpu_torch.train.loop import make_optimizer
from xna_basecaller_tpu_torch.utils.model_io import load_model
from xna_basecaller_tpu_torch.utils.weights import params_to_jax

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _ctc_cfg():
    blocks = (
        BlockConfig(filters=16, repeat=1, kernel=(9,), stride=(3,)),
        BlockConfig(filters=16, repeat=3, kernel=(7,), residual=True,
                    separable=True),
        BlockConfig(filters=32, repeat=1, kernel=(1,)),
    )
    return ModelConfig(labels=tuple("NACGT"), blocks=blocks,
                       package="xna_basecaller_tpu.models.ctc_model")


def _ctc_batch(n=6, T_sig=330, L=20, seed=3):
    rng = np.random.default_rng(seed)
    chunks = rng.normal(size=(n, T_sig)).astype(np.float32)
    lengths = rng.integers(5, L + 1, size=n)
    targets = np.zeros((n, L), np.int64)
    for i in range(n):
        targets[i, :lengths[i]] = rng.integers(1, 5, size=lengths[i])
    return tuple(torch.from_numpy(a) for a in (chunks, targets, lengths))


def test_ctc_forward_and_train_step_on_the_card(cuda):
    cfg = _ctc_cfg()
    cpu = ctc_model.CtcModel(cfg, device="cpu", seed=0)
    gpu = ctc_model.CtcModel(cfg, device=cuda, seed=0)
    c, t, l = _ctc_batch()
    torch.testing.assert_close(gpu(c.to(cuda)).cpu(), cpu(c), rtol=1e-4,
                               atol=1e-4)
    lc, _ = ctc_model.train_step(cpu, make_optimizer(cpu, lambda _: 1e-3),
                                 c, t, l)
    lg, _ = ctc_model.train_step(gpu, make_optimizer(gpu, lambda _: 1e-3),
                                 c.to(cuda), t.to(cuda), l.to(cuda))
    np.testing.assert_allclose(lg.item(), lc.item(), rtol=1e-4)
    torch.testing.assert_close(gpu.blocks[1].convs[0].bn.mean.cpu(),
                               cpu.blocks[1].convs[0].bn.mean, rtol=1e-4,
                               atol=1e-5)


def test_mods_forward_on_the_card(cuda):
    cfg = mods_model.ModsConfig()
    params = mods_model.init_mods_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    sig = rng.normal(size=(64, cfg.sig_window)).astype(np.float32)
    ctx = rng.integers(0, 7, size=(64, 2 * cfg.context + 1))
    cpu = mods_model.mods_forward(
        mods_model.ModsModel(cfg, params, device="cpu"), sig, ctx)
    gpu = mods_model.mods_forward(
        mods_model.ModsModel(cfg, params, device=cuda), sig, ctx)
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_read_transition_probs_on_the_card(cuda, tmp_path, reverse):
    cfg = ModelConfig(encoder=EncoderConfig(features=64, num_rnn_layers=2))
    d = str(tmp_path / "m")
    os.makedirs(d)
    config_lib.save(cfg, d)
    ckpt.save_checkpoint(d, 1, params_to_jax(
        Model(cfg, device="cpu", seed=0).state_dict()))
    sig = np.random.default_rng(5).normal(size=2700).astype(np.float32)
    cpu, _ = load_model(d, device="cpu")
    gpu, _ = load_model(d, device=cuda)
    tc, ic = pair_decode.read_transition_probs(cpu, sig, 1000, 200,
                                               reverse=reverse)
    tg, ig = pair_decode.read_transition_probs(gpu, sig, 1000, 200,
                                               reverse=reverse)
    np.testing.assert_allclose(np.exp(tg), np.exp(tc), atol=1e-4)
    np.testing.assert_allclose(np.exp(ig), np.exp(ic), atol=1e-4)
