"""Reference-format checkpoints (bonito's ``weights_N.tar``) in the port
against the JAX package: ``import_state_dict`` maps a seeded reference
state_dict to the tensors JAX's import gives (through ``params_from_jax``),
with and without the ``module.`` prefix and ``linear_ext``; a
``weights_N.tar`` beside a ``config.toml`` loads through both packages'
``load_model`` to the same weights (the latest tar, ``weights=``, and
``skip_top``); the f32 forward's labels equal JAX's; JAX's two
``ValueError``s.  Every comparison is exact: the import only moves and
transposes f32 values."""

import os
import pickle
from dataclasses import replace
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu.infer.basecall import compute_scores
from xna_basecaller_tpu.utils import torch_import as jimport
from xna_basecaller_tpu.utils.model_io import load_model as jax_load_model
from xna_basecaller_tpu_torch.core.config import (
    EncoderConfig as TEncoderConfig, ModelConfig as TModelConfig,
)
from xna_basecaller_tpu_torch.infer.basecall import _score_and_decode
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.utils import torch_import as timport
from xna_basecaller_tpu_torch.utils.model_io import load_model
from xna_basecaller_tpu_torch.utils.weights import params_from_jax

LAYERS = 2


def _cfgs(extra_linear=False):
    kw = dict(features=32, num_rnn_layers=LAYERS, extra_linear=extra_linear)
    return (ModelConfig(encoder=EncoderConfig(**kw)),
            TModelConfig(encoder=TEncoderConfig(**kw)))


def reference_state_dict(tcfg, seed=0, prefix="", ext=False):
    """A bonito-layout state_dict of ``tcfg`` with the weights of
    ``Model(tcfg, seed=seed)`` (the JAX init's distributions: random
    weights of unit scale saturate the CRF head, whose ties no two f32
    decodes settle alike), through ``export_state_dict``; with ``ext`` the
    extra linear layer too."""
    if ext:
        tcfg = replace(tcfg, encoder=replace(tcfg.encoder, extra_linear=True))
    sd = timport.export_state_dict(
        Model(tcfg, device="cpu", seed=seed).state_dict())
    return {prefix + k: v for k, v in sd.items()}


def test_export_state_dict_is_the_reference_layout():
    """The Serial's layout: convs 0-2, Permute 3, LSTMs 4.., head last."""
    _, tcfg = _cfgs()
    sd = reference_state_dict(tcfg)
    assert sorted({k.split(".")[1] for k in sd}, key=int) == [
        "0", "1", "2", "4", "5", "6"]
    assert tuple(sd["encoder.4.rnn.weight_ih_l0"].shape) == (128, 32)
    assert not sd["encoder.5.rnn.bias_hh_l0"].any()
    assert tuple(sd["encoder.6.linear.weight"].shape) == (1296, 32)


def assert_same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("ext", [False, True])
def test_import_state_dict_matches_jax(prefix, ext):
    jcfg, tcfg = _cfgs(extra_linear=ext)
    sd = reference_state_dict(tcfg, prefix=prefix, ext=ext)
    got = timport.import_state_dict(sd, tcfg)
    want = params_from_jax(jimport.import_state_dict(sd, jcfg))
    assert_same_state(got, want)
    # the port's model takes it as it is
    Model(tcfg, device="cpu", seed=None).load_state_dict(got)


@pytest.fixture()
def tar_dir(tmp_path):
    """weights_1.tar and weights_3.tar (other seeds) beside config.toml."""
    jcfg, tcfg = _cfgs()
    jconfig.save(jcfg, str(tmp_path))
    for epoch, seed in ((1, 11), (3, 33)):
        torch.save(reference_state_dict(tcfg, seed=seed),
                   tmp_path / f"weights_{epoch}.tar")
    return str(tmp_path), tcfg


def test_load_model_takes_the_latest_tar_as_jax_does(tar_dir):
    d, _ = tar_dir
    _, params, _ = jax_load_model(d)
    model, cfg = load_model(d, device="cpu")
    assert_same_state(model.state_dict(), params_from_jax(params))
    assert cfg.encoder.num_rnn_layers == LAYERS


def test_load_model_weights_names_a_tar(tar_dir):
    """``weights=1`` loads weights_1.tar (JAX's ``load_model`` looks for
    weights_1.npz only and raises; its importer gives the same tensors)."""
    d, tcfg = tar_dir
    with pytest.raises(FileNotFoundError):
        jax_load_model(d, weights=1)
    model, _ = load_model(d, device="cpu", weights=1)
    want = params_from_jax(jimport.load_torch_checkpoint(
        os.path.join(d, "weights_1.tar"), _cfgs()[0]))
    assert_same_state(model.state_dict(), want)
    latest, _ = load_model(d, device="cpu", weights=3)
    assert_same_state(latest.state_dict(),
                      load_model(d, device="cpu")[0].state_dict())


def test_load_model_skip_top_keeps_a_fresh_head(tar_dir):
    """``skip_top``: the body from the tar (as JAX's), the head the fresh
    one of ``Model(cfg, seed)`` (JAX's fresh head is its own init)."""
    d, tcfg = tar_dir
    _, params, _ = jax_load_model(d, skip_top=True, seed=5)
    model, _ = load_model(d, device="cpu", skip_top=True, seed=5)
    got, want = model.state_dict(), params_from_jax(params)
    fresh = Model(tcfg, device="cpu", seed=5).state_dict()
    for k in got:
        if k.startswith("head"):
            torch.testing.assert_close(got[k], fresh[k], rtol=0, atol=0)
        else:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_tar_forward_labels_match_jax(tar_dir):
    """The f32 forward and Viterbi decode of a tar-loaded model: labels
    equal to JAX's ``compute_scores`` on the same tar (fixture with no f32
    near-ties)."""
    d, tcfg = tar_dir
    jmodel, params, _ = jax_load_model(d)
    batch = np.random.default_rng(2).normal(size=(3, 1200)).astype(
        np.float32)
    want = compute_scores(jmodel, params, batch,
                          compute_dtype=jnp.float32)["path"]
    model, _ = load_model(d, device="cpu")
    with torch.inference_mode():
        scores = model(torch.from_numpy(batch.astype(np.float16)),
                       torch.float32)
        got = _score_and_decode(scores, model.seqdist.n_base,
                                model.seqdist.state_len).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any()


@pytest.mark.parametrize("case", ["no_rnn", "layers"])
def test_import_refuses_what_jax_refuses(case):
    jcfg, tcfg = _cfgs()
    sd = reference_state_dict(tcfg)
    if case == "no_rnn":
        sd = {k: v for k, v in sd.items() if ".rnn." not in k}
    else:
        sd = {k: v for k, v in sd.items() if not k.startswith("encoder.5.")}
    msgs = []
    for mod, cfg in ((jimport, jcfg), (timport, tcfg)):
        with pytest.raises(ValueError) as exc:
            mod.import_state_dict(sd, cfg)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert ("does not look like" in msgs[0]) == (case == "no_rnn")


def test_load_torch_checkpoint_reads_weights_only(tmp_path):
    """The tar is read with ``weights_only=True``: a plain state_dict
    loads, a pickled object does not."""
    _, tcfg = _cfgs()
    sd = reference_state_dict(tcfg)
    torch.save(sd, tmp_path / "w.tar")
    assert_same_state(
        timport.load_torch_checkpoint(str(tmp_path / "w.tar"), tcfg),
        timport.import_state_dict(sd, tcfg))
    torch.save({"encoder.0.conv.weight": Fraction(1, 3)},
               tmp_path / "bad.tar")
    with pytest.raises(pickle.UnpicklingError, match="weights_only"):
        timport.load_torch_checkpoint(str(tmp_path / "bad.tar"), tcfg)
