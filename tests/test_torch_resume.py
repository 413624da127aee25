"""Optimizer state across packages: each package resumes from the other's
``optim_N.npz``.  The port writes optax's state tree as the JAX package
does for the same run (``1/0/count``, ``1/0/mu/<key>``, ``1/0/nu/<key>``,
``1/2/count``, convolution moments as [k, in, out]; with frozen
parameters the ``optax.multi_transform`` tree, moments of the trained
keys only), and reads both trees and its own earlier layout.

After a resume the next step (f32, CPU) is held to the uninterrupted
run of the other package with ``test_torch_train.py``'s tolerance for
one ``train_step``: parameters within 2e-6 but for 0.1 % of each tensor's
elements, none further than 2.2e-3.  The resumed step differs from the
other package's only by that step's own rounding: the parameters and the
moments it starts from are the same numbers.

Through the Trainers, each package resumes epoch 2 from the other's epoch
1 and is held to the other package's own resume with the same tolerance.
JAX's Trainer loads the optimizer through a plain-chain template, so it
cannot resume from the ``multi_transform`` file its own frozen run
writes; the port reads that file.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu.data.ctc_data import ChunkDataset as JaxDataset
from xna_basecaller_tpu.data.simulate import simulate_ctc_dataset
from xna_basecaller_tpu.models.crf_model import Model as JaxModel
from xna_basecaller_tpu.train import checkpoint as jckpt
from xna_basecaller_tpu.train import loop as jloop
from xna_basecaller_tpu_torch.core import config as tconfig
from xna_basecaller_tpu_torch.data.ctc_data import ChunkDataset
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.train import checkpoint as ckpt
from xna_basecaller_tpu_torch.train.loop import (
    MULTI_PREFIX, Trainer, make_optimizer, train_step,
)
from xna_basecaller_tpu_torch.utils.weights import (
    params_from_jax, params_to_jax,
)

CFG = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2,
                                        winlen=9))


def _frozen(key):
    return key.startswith("conv")


def _schedule(step):
    # jnp-traceable and float alike: the count enters the lr
    return 1e-3 / (1.0 + step)


def _batches():
    c, t, l, _ = simulate_ctc_dataset(8, chunk_len=600, target_len=70,
                                      seed=0)
    arrs = (c.astype(np.float32), t.astype(np.int32), l.astype(np.int32))
    return [tuple(a[i:i + 4] for a in arrs) for i in (0, 4)]


def _port_model(weights):
    model = Model(tconfig.from_dict(jconfig.to_dict(CFG)), device="cpu",
                  seed=None)
    model.load_state_dict(params_from_jax(weights))
    return model


def _jax_optimizer(params, frozen: bool):
    opt = jloop.make_optimizer(_schedule)
    if not frozen:
        return opt
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: "frozen" if _frozen("/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path))
        else "train", params)
    return optax.multi_transform(
        {"train": opt, "frozen": optax.set_to_zero()}, param_labels=labels)


def _jax_step(params, state, batch, opt):
    params, state, _, _ = jloop.train_step(
        jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, state),
        *batch, CFG, opt, jnp.float32, 1)
    return jax.device_get(params), jax.device_get(state)


def _port_step(model, opt, batch):
    train_step(model, opt, *(torch.from_numpy(a) for a in batch),
               compute_dtype=torch.float32)


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in got.items():
        diff = np.abs(v - want[k])
        assert (diff > 2e-6).mean() <= 1e-3, k
        assert diff.max() <= 2.2e-3, k


@pytest.mark.parametrize("frozen", [False, True], ids=["plain", "frozen"])
def test_port_resumes_from_jax_optim(frozen, tmp_path):
    """JAX takes a step and saves; the port loads that optimizer file and
    takes the next step, which agrees with JAX's uninterrupted second
    step."""
    b1, b2 = _batches()
    p0 = jax.device_get(JaxModel(CFG).init(jax.random.key(0)))
    opt = _jax_optimizer(p0, frozen)
    p1, s1 = _jax_step(p0, opt.init(p0), b1, opt)
    jckpt.save_checkpoint(str(tmp_path), 1, p1, s1)
    p2, _ = _jax_step(p1, s1, b2, opt)

    epoch, weights, optim = ckpt.load_checkpoint(str(tmp_path),
                                                 with_optim=True)
    assert epoch == 1
    assert (f"{MULTI_PREFIX}1/0/count" in optim) == frozen
    model = _port_model(weights)
    port_opt = make_optimizer(model, _schedule,
                              frozen_predicate=_frozen if frozen else None)
    port_opt.load_state_flat(optim)
    assert port_opt.count == 1
    # the port writes back what it read, key for key and bit for bit
    written = port_opt.state_flat()
    assert written.keys() == optim.keys()
    for k, v in written.items():
        np.testing.assert_array_equal(v, optim[k], err_msg=k)
    _port_step(model, port_opt, b2)
    _close(params_to_jax(model.state_dict()), _flat(p2))


@pytest.mark.parametrize("frozen", [False, True], ids=["plain", "frozen"])
def test_jax_resumes_from_port_optim(frozen, tmp_path):
    """The port takes a step and saves; JAX loads that optimizer file into
    optax's own state template (plain chain or multi_transform) and takes
    the next step, which agrees with the port's uninterrupted second
    step."""
    b1, b2 = _batches()
    p0 = jax.device_get(JaxModel(CFG).init(jax.random.key(1)))
    model = _port_model(p0)
    opt = make_optimizer(model, _schedule,
                         frozen_predicate=_frozen if frozen else None)
    _port_step(model, opt, b1)
    ckpt.save_checkpoint(str(tmp_path), 1, params_to_jax(model.state_dict()),
                         opt.state_flat())
    _port_step(model, opt, b2)

    jopt = _jax_optimizer(p0, frozen)
    epoch, p1, s1 = jckpt.load_checkpoint(str(tmp_path), p0, jopt.init(p0))
    assert epoch == 1
    assert int(_flat(s1)[(MULTI_PREFIX if frozen else "")
                         + "1/0/count"]) == 1
    p2, _ = _jax_step(p1, s1, b2, jopt)
    _close(params_to_jax(model.state_dict()), _flat(p2))


def test_port_reads_its_earlier_layout():
    """Workdirs written before the port wrote JAX's layout still resume:
    ``count`` and ``<key>/mu``, ``<key>/nu`` in the port's own parameter
    layout."""
    p0 = jax.device_get(JaxModel(CFG).init(jax.random.key(2)))
    model = _port_model(p0)
    opt = make_optimizer(model, _schedule)
    _port_step(model, opt, _batches()[0])
    old = {"count": np.asarray(1, np.int64)}
    for k, p in opt.named:
        st = opt.adamw.state[p]
        old[f"{k}/mu"] = st["exp_avg"].numpy().copy()
        old[f"{k}/nu"] = st["exp_avg_sq"].numpy().copy()
    back = make_optimizer(model, _schedule)
    back.load_state_flat(old)
    for (k, p), (_, q) in zip(opt.named, back.named):
        for name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(back.adamw.state[q][name],
                                       opt.adamw.state[p][name], rtol=0,
                                       atol=0)
    assert back.count == 1


def test_counts_that_differ_are_refused():
    model = _port_model(jax.device_get(JaxModel(CFG).init(
        jax.random.key(3))))
    opt = make_optimizer(model, _schedule)
    flat = opt.state_flat()
    flat["1/2/count"] = np.asarray(5, np.int32)
    with pytest.raises(ValueError, match="counts differ"):
        make_optimizer(model, _schedule).load_state_flat(flat)


def _datasets():
    c, t, l, b = simulate_ctc_dataset(8, chunk_len=600, target_len=70,
                                      seed=4)
    c = c.astype(np.float32)
    return {pkg: (cls(c[:4], t[:4], l[:4], b[:4]),
                  cls(c[4:], t[4:], l[4:], b[4:], epoch_reset_seed=True))
            for pkg, cls in (("port", ChunkDataset), ("jax", JaxDataset))}


def _fit(pkg, workdir, epochs, data, frozen=False):
    kw = dict(batchsize=4, lr=2e-3, warmup_steps=3, save_optim_every=1,
              restore_optim=True, log=lambda *a: None,
              frozen_predicate=_frozen if frozen else None)
    if pkg == "jax":
        jloop.Trainer(JaxModel(CFG), *data["jax"],
                      compute_dtype=jnp.float32, **kw).fit(workdir, epochs)
    else:
        model = _port_model(jax.device_get(JaxModel(CFG).init(
            jax.random.key(25))))
        Trainer(model, *data["port"], compute_dtype=torch.float32,
                **kw).fit(workdir, epochs)


@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_trainers_resume_each_others_epoch(first, then, tmp_path):
    """``first`` trains epoch 1; ``then`` and ``first`` each resume epoch 2
    from it with ``restore_optim``: the two epoch-2 weights agree."""
    data = _datasets()
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _fit(first, a, 1, data)
    shutil.copytree(a, b)
    _fit(then, a, 2, data)
    _fit(first, b, 2, data)
    got = ckpt.load_flat(os.path.join(a, "weights_2.npz"))
    want = ckpt.load_flat(os.path.join(b, "weights_2.npz"))
    _close(got, want)
    assert ckpt.load_flat(os.path.join(a, "optim_2.npz")).keys() \
        == ckpt.load_flat(os.path.join(b, "optim_2.npz")).keys()


def test_port_resumes_jax_frozen_trainer(tmp_path):
    """JAX's frozen run writes the multi_transform tree; JAX's own Trainer
    cannot resume from it (its template is the plain chain); the port
    resumes, its frozen parameters stay where they were, and it writes
    the same tree for epoch 2."""
    data = _datasets()
    run = str(tmp_path / "run")
    _fit("jax", run, 1, data, frozen=True)
    optim_1 = ckpt.load_flat(os.path.join(run, "optim_1.npz"))
    assert f"{MULTI_PREFIX}1/0/count" in optim_1
    assert not any(k.startswith(f"{MULTI_PREFIX}1/0/mu/conv")
                   for k in optim_1)
    shutil.copytree(run, str(tmp_path / "jax"))
    with pytest.raises(KeyError):
        _fit("jax", str(tmp_path / "jax"), 2, data, frozen=True)
    _fit("port", run, 2, data, frozen=True)
    w1 = ckpt.load_flat(os.path.join(run, "weights_1.npz"))
    w2 = ckpt.load_flat(os.path.join(run, "weights_2.npz"))
    for k in w1:
        assert np.array_equal(w1[k], w2[k]) == k.startswith("conv"), k
    optim_2 = ckpt.load_flat(os.path.join(run, "optim_2.npz"))
    assert optim_2.keys() == optim_1.keys()
    assert int(optim_2[f"{MULTI_PREFIX}1/2/count"]) == 2
