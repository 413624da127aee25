"""The port's training step, optimizer, schedule, checkpoints, Trainer,
``merge_ctc_dirs``, ``load_script`` and ``train`` CLI (CPU, with and
without the augmentations) against the JAX package.

Tolerances (f32): one ``train_step`` from the same weights on the same
batch: loss rtol 1e-5, grad_norm rtol 1e-4 (a sum of squares over
gradients that carry the loss's 1e-4 tolerance, see test_torch_loss.py),
the clipped gradients rtol 1e-3 with atol 1e-4 of each tensor's largest
element (the loss's gradient carries rtol 1e-4 into the whole network);
parameters after the step atol 2e-6 (the step is lr 1e-3 times AdamW's
g / (|g| + eps) at the first step, about 1e-3, so 2e-6 is its third digit)
for all but 0.1% of each tensor's elements, whose gradients lie within
rounding of zero and may take either sign; ``grad_accum_split=2`` against 1 as
JAX's test of the same (loss rel 1e-4, params rtol 1e-3 atol 1e-5); the
schedule rel 1e-6 (JAX evaluates it in f32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu.data.simulate import simulate_ctc_dataset
from xna_basecaller_tpu.models import crf_model as jmodel
from xna_basecaller_tpu.models.crf_model import Model as JaxModel
from xna_basecaller_tpu.train import checkpoint as jckpt
from xna_basecaller_tpu.train import loop as jloop
from xna_basecaller_tpu.train.schedule import (
    linear_warmup_cosine_decay as jax_schedule,
)
from xna_basecaller_tpu_torch.cli import main as port_cli
from xna_basecaller_tpu_torch.core import config as tconfig
from xna_basecaller_tpu_torch.data.ctc_data import (
    ChunkDataset, save_ctc_data,
)
from xna_basecaller_tpu_torch.models.crf_model import Model, apply_dropout
from xna_basecaller_tpu_torch.train import checkpoint as ckpt
from xna_basecaller_tpu_torch.train.loop import (
    Trainer, make_optimizer, train_step,
)
from xna_basecaller_tpu_torch.train.schedule import (
    linear_warmup_cosine_decay,
)
from xna_basecaller_tpu_torch.utils.model_io import load_model
from xna_basecaller_tpu_torch.utils.weights import (
    jax_key, params_from_jax, params_to_jax,
)


def _cfg(**enc):
    return ModelConfig(encoder=EncoderConfig(
        features=32, num_rnn_layers=2, winlen=9, **enc))


def _port_model(cfg, params):
    model = Model(tconfig.from_dict(jconfig.to_dict(cfg)), device="cpu",
                  seed=None)
    model.load_state_dict(params_from_jax(params))
    return model


def _batch(n=4, seed=0):
    c, t, l, _ = simulate_ctc_dataset(n, chunk_len=600, target_len=70,
                                      seed=seed)
    return (c.astype(np.float32), t.astype(np.int32), l.astype(np.int32))


def _datasets(n=16, seed=0):
    c, t, l, b = simulate_ctc_dataset(n, chunk_len=600, target_len=70,
                                      seed=seed)
    return (ChunkDataset(c[: n - 4], t[: n - 4], l[: n - 4], b[: n - 4]),
            ChunkDataset(c[n - 4:], t[n - 4:], l[n - 4:], b[n - 4:],
                         epoch_reset_seed=True))


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def test_train_step_f32_matches_jax():
    cfg = _cfg()
    params = JaxModel(cfg).init(jax.random.key(0))
    c, t, l = _batch()
    l[-1] = 0     # a padding row: masked out of the mean
    model = _port_model(cfg, params)
    opt = jloop.make_optimizer(lambda _: 1e-3)
    p_j, _, loss_j, gn_j = jloop.train_step(
        jax.tree.map(jnp.array, params), opt.init(params), c, t, l, cfg, opt,
        jnp.float32, 1)
    loss, gn = train_step(model, make_optimizer(model, lambda _: 1e-3),
                          *(torch.from_numpy(a) for a in (c, t, l)),
                          compute_dtype=torch.float32)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(gn.item(), float(gn_j), rtol=1e-4)

    # the gradients, clipped as the step clips them (the loss function of
    # loop.py:58-68 there)
    def loss_fn(p):
        scores = jmodel.forward(p, jnp.asarray(c), cfg, jnp.float32)
        per = JaxModel(cfg).seqdist.ctc_loss(
            scores, t, jnp.maximum(l, cfg.state_len + 1), reduction="none")
        valid = (l > 0).astype(jnp.float32)
        return jnp.sum(per * valid) / jnp.maximum(valid.sum(), 1.0)
    scale = min(1.0, 2.0 / float(gn_j))
    g_j = {k: v * scale for k, v in _flat(jax.grad(loss_fn)(params)).items()}
    g_port = {jax_key(n): p.grad.numpy() for n, p in model.named_parameters()}
    g_port = {k: v.transpose(2, 1, 0) if k.startswith("conv/") and
              k.endswith("/w") else v for k, v in g_port.items()}
    for k, want in g_j.items():
        np.testing.assert_allclose(g_port[k], want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)

    # the parameters after the step: AdamW's first step moves an element
    # by lr * g / (|g| + eps), about lr whatever |g|, so a gradient
    # component within rounding of zero may come out with another sign;
    # such elements are rare, and none may differ by more than two steps
    # (a step is at most lr (1 + wd |p|) < 1.1e-3)
    want = _flat(p_j)
    for k, v in params_to_jax(model.state_dict()).items():
        diff = np.abs(v - want[k])
        assert (diff > 2e-6).mean() <= 1e-3, k
        assert diff.max() <= 2.2e-3, k


def test_clip_and_adamw_follow_optax():
    """A gradient above the clip norm: optax's clip + adamw, two steps."""
    import optax
    cfg = _cfg()
    params = JaxModel(cfg).init(jax.random.key(1))
    model = _port_model(cfg, params)
    rng = np.random.default_rng(2)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in _flat(params).items()}
    jopt = jloop.make_optimizer(lambda s: 1e-2 / (1 + s))
    state = jopt.init(params)
    p = params
    gtree = jax.tree.map(np.zeros_like, params)
    gtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(gtree),
        [grads[k] for k in _flat(gtree)])
    opt = make_optimizer(model, lambda s: 1e-2 / (1 + s))
    named = dict(model.named_parameters())
    for _ in range(2):
        upd, state = jopt.update(gtree, state, p)
        p = optax.apply_updates(p, upd)
        g_port = params_from_jax(grads)
        for name, prm in named.items():
            prm.grad = g_port[name].clone()
        opt.step()
    want = _flat(p)
    for k, v in params_to_jax(model.state_dict()).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_grad_accum_matches_full_batch():
    cfg = _cfg()
    params = JaxModel(cfg).init(jax.random.key(0))
    c, t, l = (torch.from_numpy(a) for a in _batch(8))
    out = []
    for split in (1, 2):
        model = _port_model(cfg, params)
        loss, _ = train_step(model, make_optimizer(model, lambda _: 1e-3),
                             c, t, l, torch.float32, split)
        out.append((loss.item(), params_to_jax(model.state_dict())))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-4)
    for k in out[0][1]:
        np.testing.assert_allclose(out[0][1][k], out[1][1][k], rtol=1e-3,
                                   atol=1e-5)


def test_dropout_keeps_its_share_and_scales():
    """Training dropout: drop rates 0 change nothing; with rates set, the
    kept share and the 1/(1 - rate) scale are right, and a generator
    makes it repeatable."""
    cfg = tconfig.from_dict(jconfig.to_dict(_cfg(
        drop_rate=0.5, drop_rate_bottom=0.05)))
    model = Model(cfg, device="cpu", seed=0)
    sig = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 600)).astype(np.float32))

    def run(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return model(sig, torch.float32, inference=False, dropout=g)

    a, b, a2 = run(1), run(2), run(1)
    assert not torch.allclose(a, b)
    torch.testing.assert_close(a, a2, rtol=0, atol=0)
    torch.testing.assert_close(run(None), model(sig, torch.float32),
                               rtol=0, atol=0)
    cfg0 = tconfig.from_dict(jconfig.to_dict(_cfg()))
    model0 = Model(cfg0, device="cpu", seed=0)
    torch.testing.assert_close(
        model0(sig, torch.float32, inference=False,
               dropout=torch.Generator().manual_seed(3)),
        model0(sig, torch.float32), rtol=0, atol=0)
    # the keep share and the scale
    for rate in (0.5, 0.05):
        out = apply_dropout(torch.ones(200_000), rate,
                            torch.Generator().manual_seed(4))
        assert abs((out > 0).float().mean().item() - (1 - rate)) < 5e-3
        assert out.unique().tolist() == [0.0, np.float32(1 / (1 - rate))]


def test_frozen_params_do_not_move(tmp_path):
    train, valid = _datasets(n=8)
    model = Model(tconfig.from_dict(jconfig.to_dict(_cfg())), device="cpu",
                  seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, train, valid, batchsize=4, lr=5e-3, warmup_steps=1,
                 frozen_predicate=lambda key: key.startswith("conv"),
                 log=lambda *a: None)
    tr.fit(str(tmp_path), epochs=1)
    after = model.state_dict()
    torch.testing.assert_close(after["conv.0.weight"],
                               before["conv.0.weight"], rtol=0, atol=0)
    assert not torch.allclose(after["head.w"], before["head.w"])


def test_trainer_writes_checkpoints_and_resumes(tmp_path):
    train, valid = _datasets()
    cfg = tconfig.from_dict(jconfig.to_dict(_cfg()))
    kw = dict(batchsize=4, lr=2e-3, warmup_steps=3, log=lambda *a: None)
    out = Trainer(Model(cfg, device="cpu", seed=0), train, valid,
                  **kw).fit(str(tmp_path), epochs=2)
    assert [h["epoch"] for h in out["history"]] == [1, 2]
    for f in ("weights_1.npz", "weights_2.npz", "losses_1.csv",
              "losses_2.csv", "training.csv"):
        assert os.path.exists(tmp_path / f), f
    with open(tmp_path / "losses_1.csv") as fh:
        lines = fh.read().splitlines()
    assert lines[0] == "chunks,time,grad_norm,lr,loss" and len(lines) == 4
    assert all(np.isfinite(h["validation_loss"]) for h in out["history"])
    # `epochs` is the total: resuming at 2 of 3 trains exactly epoch 3,
    # from epoch 2's weights
    model = Model(cfg, device="cpu", seed=1)
    out = Trainer(model, train, valid, **kw).fit(str(tmp_path), epochs=3)
    assert [h["epoch"] for h in out["history"]] == [3]
    out = Trainer(model, train, valid, **kw).fit(str(tmp_path), epochs=3)
    assert out["history"] == []
    assert not os.path.exists(tmp_path / "weights_4.npz")


def test_resume_restores_the_optimizer(tmp_path):
    train, valid = _datasets()
    cfg = tconfig.from_dict(jconfig.to_dict(_cfg()))
    kw = dict(batchsize=4, lr=2e-3, warmup_steps=3, save_optim_every=1,
              restore_optim=True, log=lambda *a: None)
    Trainer(Model(cfg, device="cpu", seed=0), train, valid, **kw).fit(
        str(tmp_path), epochs=1)
    flat = ckpt.load_flat(str(tmp_path / "optim_1.npz"))
    assert int(flat["1/0/count"]) == int(flat["1/2/count"]) == 3
    assert "1/0/mu/rnn/0/w_hh" in flat
    model = Model(cfg, device="cpu", seed=0)
    tr = Trainer(model, train, valid, **kw)
    opt = make_optimizer(model, lambda _: 1e-3)
    opt.load_state_flat(flat)
    assert opt.count == 3
    np.testing.assert_array_equal(opt.state_flat()["1/0/nu/rnn/0/w_hh"],
                                  flat["1/0/nu/rnn/0/w_hh"])
    assert [h["epoch"] for h in tr.fit(str(tmp_path), 2)["history"]] == [2]


def test_resume_ignores_reserved_pseudo_epochs(tmp_path):
    flat = params_to_jax(Model(tconfig.from_dict(jconfig.to_dict(_cfg())),
                               device="cpu", seed=0).state_dict())
    for e in (1, 2):
        ckpt.save_checkpoint(str(tmp_path), e, flat, save_optim=False)
    ckpt.save_flat(flat, str(tmp_path / "weights_90.npz"))
    ckpt.link_best_epoch(str(tmp_path), 2)
    assert ckpt.latest_epoch(str(tmp_path)) == 99
    assert ckpt.latest_epoch(str(tmp_path), exclude_reserved=True) == 2
    assert ckpt.load_checkpoint(str(tmp_path))[0] == 2
    # a marked 90 next to a real 89 is excluded; unmarked it is progress
    for e in (88, 89):
        ckpt.save_checkpoint(str(tmp_path / "b"), e, flat, save_optim=False)
    ckpt.save_flat(flat, str(tmp_path / "b" / "weights_90.npz"))
    assert ckpt.latest_epoch(str(tmp_path / "b"), exclude_reserved=True) == 90
    ckpt.mark_reserved(str(tmp_path / "b"), 90)
    assert ckpt.latest_epoch(str(tmp_path / "b"), exclude_reserved=True) == 89


def test_weights_interchange_with_jax(tmp_path):
    """JAX reads the port's weights_1.npz, and the port JAX's."""
    cfg = _cfg()
    params = JaxModel(cfg).init(jax.random.key(3))
    model = _port_model(cfg, params)
    ckpt.save_checkpoint(str(tmp_path / "port"), 1,
                         params_to_jax(model.state_dict()))
    epoch, loaded, _ = jckpt.load_checkpoint(
        str(tmp_path / "port"), jax.tree.map(jnp.zeros_like, params))
    assert epoch == 1
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(loaded)[k], v)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 4, params)
    jconfig.save(cfg, str(tmp_path / "jax" / "config.toml"))
    port_model, _ = load_model(str(tmp_path / "jax"), device="cpu")
    for k, v in params_to_jax(port_model.state_dict()).items():
        np.testing.assert_array_equal(v, _flat(params)[k])
    # and the port's Trainer resumes from JAX's weights
    tr = Trainer(Model(tconfig.from_dict(jconfig.to_dict(cfg)),
                       device="cpu", seed=9), *_datasets(8), batchsize=4,
                 log=lambda *a: None)
    assert tr.fit(str(tmp_path / "jax"), epochs=4)["history"] == []
    for k, v in params_to_jax(tr.model.state_dict()).items():
        np.testing.assert_array_equal(v, _flat(params)[k])


def test_load_model_skip_top_and_drop_rates(tmp_path):
    cfg = _cfg()
    params = JaxModel(cfg).init(jax.random.key(4))
    jckpt.save_checkpoint(str(tmp_path), 1, params)
    jconfig.save(cfg, str(tmp_path / "config.toml"))
    model, pcfg = load_model(str(tmp_path), device="cpu", skip_top=True,
                             drop_rate=0.3, drop_rate_bottom=0.1, seed=5)
    assert (pcfg.encoder.drop_rate, pcfg.encoder.drop_rate_bottom) == (0.3,
                                                                       0.1)
    got = params_to_jax(model.state_dict())
    want = _flat(params)
    np.testing.assert_array_equal(got["rnn/1/w_hh"], want["rnn/1/w_hh"])
    assert not np.array_equal(got["head/w"], want["head/w"])
    fresh = params_to_jax(Model(tconfig.from_dict(jconfig.to_dict(cfg)),
                                device="cpu", seed=5).state_dict())
    np.testing.assert_array_equal(got["head/w"], fresh["head/w"])


@pytest.mark.parametrize("step", [0, 1, 37, 100, 499, 500, 501, 999, 1000,
                                  2000])
def test_schedule_matches_jax(step):
    kw = dict(total_steps=1000, warmup_steps=100, start_step=7)
    want = float(jax_schedule(2e-3, **kw)(step))
    assert linear_warmup_cosine_decay(2e-3, **kw)(step) == pytest.approx(
        want, rel=1e-6)


def test_cli_trains_on_cpu(tmp_path):
    c, t, l, b = simulate_ctc_dataset(12, chunk_len=600, target_len=70)
    save_ctc_data(str(tmp_path / "data"), c, t, l, b)
    cfg = _cfg()
    jconfig.save(cfg, str(tmp_path / "config.toml"))
    port_cli(["train", str(tmp_path / "run"), "--directory",
              str(tmp_path / "data"), "--config",
              str(tmp_path / "config.toml"), "--device", "cpu", "--epochs",
              "1", "--batch", "4", "--valid-chunks", "2"])
    for f in ("weights_1.npz", "losses_1.csv", "training.csv", "config.toml",
              "argv.txt"):
        assert os.path.exists(tmp_path / "run" / f), f
    # JAX reads the directory the port trained
    _, params, jcfg = __import__(
        "xna_basecaller_tpu.utils.model_io",
        fromlist=["load_model"]).load_model(str(tmp_path / "run"))
    assert jcfg.encoder.features == 32 and "rnn" in params
    # fine-tune from it: a fresh head, everything below the top LSTM frozen
    port_cli(["train", str(tmp_path / "tune"), "--directory",
              str(tmp_path / "data"), "--pretrained", str(tmp_path / "run"),
              "--skip-top", "--freeze-bottom", "--unfreeze-top", "1",
              "--device", "cpu", "--epochs", "1", "--batch", "4"])
    before = ckpt.load_flat(str(tmp_path / "run" / "weights_1.npz"))
    after = ckpt.load_flat(str(tmp_path / "tune" / "weights_1.npz"))
    for k in ("conv/0/w", "rnn/0/w_hh"):
        np.testing.assert_array_equal(after[k], before[k])
    assert not np.array_equal(after["rnn/1/w_hh"], before["rnn/1/w_hh"])


def test_cli_trains_without_augmentation_given_only_its_knobs(tmp_path):
    """``--ubs X --ub-prop 0.1`` without ``--spike``/``--stitch``: JAX's
    ``need_bkps`` is false and it trains with no augmentation; so does the
    port, to the same weights as a run without the knobs."""
    c, t, l, b = simulate_ctc_dataset(12, chunk_len=600, target_len=70)
    save_ctc_data(str(tmp_path / "data"), c, t, l, b)
    jconfig.save(_cfg(), str(tmp_path / "config.toml"))
    base = ["--directory", str(tmp_path / "data"), "--config",
            str(tmp_path / "config.toml"), "--device", "cpu", "--epochs", "1",
            "--batch", "4", "--valid-chunks", "2"]
    port_cli(["train", str(tmp_path / "plain"), *base])
    port_cli(["train", str(tmp_path / "knobs"), *base, "--ubs", "X",
              "--ub-prop", "0.1", "--noise-std", "2.0", "--fully-synth"])
    want = ckpt.load_flat(str(tmp_path / "plain" / "weights_1.npz"))
    got = ckpt.load_flat(str(tmp_path / "knobs" / "weights_1.npz"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_load_model_weights_0_loads_epoch_0(tmp_path):
    """``weights=0`` names ``weights_0.npz``, as in JAX's ``load_model``;
    ``weights=None`` loads the latest epoch."""
    cfg = _cfg()
    jconfig.save(cfg, str(tmp_path / "config.toml"))
    params = {e: JaxModel(cfg).init(jax.random.key(e)) for e in (0, 1)}
    for e, p in params.items():
        jckpt.save_checkpoint(str(tmp_path), e, p)
    for weights, epoch in ((0, 0), (1, 1), (None, 1)):
        model, _ = load_model(str(tmp_path), device="cpu", weights=weights)
        got = params_to_jax(model.state_dict())
        for k, v in _flat(params[epoch]).items():
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("limits", [None, [3, None]])
def test_merge_ctc_dirs_matches_jax(tmp_path, limits):
    """Hybrid data prep: a DNA pack and an XNA pack merged, padded to the
    widest target and shuffled, bit-equal to JAX's for one seed."""
    from xna_basecaller_tpu.data import ctc_data as jdata
    from xna_basecaller_tpu_torch.data import ctc_data

    save_ctc_data(str(tmp_path / "dna"), *simulate_ctc_dataset(
        6, chunk_len=400, target_len=50, seed=1))
    save_ctc_data(str(tmp_path / "xna"), *simulate_ctc_dataset(
        4, chunk_len=400, target_len=60, seed=2, ub_prop=0.05))
    dirs = (str(tmp_path / "dna"), str(tmp_path / "xna"))
    n = ctc_data.merge_ctc_dirs(str(tmp_path / "port"), *dirs, limits=limits)
    n_j = jdata.merge_ctc_dirs(str(tmp_path / "jax"), *dirs, limits=limits)
    assert n == n_j == (10 if limits is None else 7)
    for f in ("chunks", "references", "reference_lengths", "breakpoints"):
        got = np.load(tmp_path / "port" / f"{f}.npy")
        want = np.load(tmp_path / "jax" / f"{f}.npy")
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert np.load(tmp_path / "port" / "references.npy").shape[1] >= 60
    a = np.zeros((2, 300), np.float16)
    save_ctc_data(str(tmp_path / "short"), a, a[:, :5], np.zeros(2), a[:, :5])
    with pytest.raises(ValueError, match="chunk lengths"):
        ctc_data.merge_ctc_dirs(str(tmp_path / "bad"), dirs[0],
                                str(tmp_path / "short"))


_DATASET_PY = {
    "datasets": (
        "import numpy as np\n"
        "from xna_basecaller_tpu_torch.data.ctc_data import ChunkDataset\n"
        "def _mk(n, **kw):\n"
        "    rng = np.random.default_rng(n)\n"
        "    return ChunkDataset(rng.normal(size=(n, 100)).astype(np.float16),\n"
        "                        rng.integers(1, 5, (n, 10)).astype(np.uint8),\n"
        "                        np.full((n,), 10, np.uint16))\n"
        "class Loader:\n"
        "    def train_dataset(self, **kw):\n"
        "        return _mk(8, **kw)\n"
        "    def valid_dataset(self, **kw):\n"
        "        return _mk(2, **kw)\n"),
    "loader_kwargs": (
        "import numpy as np\n"
        "from xna_basecaller_tpu_torch.data.ctc_data import ChunkDataset\n"
        "def _mk(n):\n"
        "    rng = np.random.default_rng(n)\n"
        "    return ChunkDataset(rng.normal(size=(n, 100)).astype(np.float16),\n"
        "                        rng.integers(1, 5, (n, 10)).astype(np.uint8),\n"
        "                        np.full((n,), 10, np.uint16))\n"
        "class Loader:\n"
        "    def train_loader_kwargs(self, **kw):\n"
        "        return {'dataset': _mk(kw.get('n', 8)), 'shuffle': True}\n"
        "    def valid_loader_kwargs(self, **kw):\n"
        "        return {'dataset': _mk(2)}\n"),
}


@pytest.mark.parametrize("form", sorted(_DATASET_PY))
def test_load_script_matches_jax(tmp_path, form):
    """``<dir>/dataset.py``'s Loader (either form) gives the datasets that
    JAX's load_script gives for the same file (reference data.py:89-96)."""
    from xna_basecaller_tpu.data.ctc_data import load_script as jload_script
    from xna_basecaller_tpu_torch.data.ctc_data import load_script

    (tmp_path / "dataset.py").write_text(_DATASET_PY[form])
    kw = {"n": 6} if form == "loader_kwargs" else {}
    got = load_script(str(tmp_path), **kw)
    want = jload_script(str(tmp_path), **kw)
    assert [len(d) for d in got] == [len(d) for d in want] == \
        [6 if kw else 8, 2]
    for g, w in zip(got, want):
        for f in ("chunks", "targets", "lengths"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    batch = next(got[0].batches(4))
    assert batch[0].shape == (4, 100) and batch[0].dtype == np.float32


@pytest.fixture()
def cli_data(tmp_path):
    """Simulated ctc-data with breakpoints, a stitch donor directory and a
    tiny model's config; returns the train command's common arguments."""
    from test_torch_stitch import write_donors

    c, t, l, b = simulate_ctc_dataset(12, chunk_len=600, target_len=70)
    save_ctc_data(str(tmp_path / "data"), c, t, l, b)
    write_donors(tmp_path / "xna", chunk_len=600)
    jconfig.save(_cfg(), str(tmp_path / "config.toml"))
    return ["--directory", str(tmp_path / "data"), "--config",
            str(tmp_path / "config.toml"), "--device", "cpu", "--epochs", "1",
            "--batch", "4", "--valid-chunks", "2"]


def _losses(run):
    import csv

    with open(os.path.join(run, "losses_1.csv")) as fh:
        rows = list(csv.DictReader(fh))
    with open(os.path.join(run, "training.csv")) as fh:
        val = list(csv.DictReader(fh))[-1]
    return [float(r["loss"]) for r in rows], float(val["validation_loss"])


def test_cli_spike_without_ubs_trains_the_plain_run(tmp_path, cli_data):
    """``--spike`` without ``--ubs`` inserts nothing: JAX's ``need_bkps``
    is false, so the weights are the plain run's."""
    port_cli(["train", str(tmp_path / "plain"), *cli_data])
    port_cli(["train", str(tmp_path / "spike"), *cli_data, "--spike"])
    want = ckpt.load_flat(str(tmp_path / "plain" / "weights_1.npz"))
    got = ckpt.load_flat(str(tmp_path / "spike" / "weights_1.npz"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("flags", [
    ["--spike", "--ubs", "XY"],
    ["--stitch", "--ubs", "X", "--xna-ctc-dir", "{xna}"],
    ["--stitch", "--stitch-relax", "--spike", "--ubs", "XY",
     "--synth-prop-ubs", "0.05", "--xna-ctc-dir", "{xna}"],
], ids=["spike", "stitch", "stitch-relax-spike"])
def test_cli_trains_with_augmentation(tmp_path, cli_data, flags):
    """One epoch to finite losses; the augmented runs differ from the
    plain run where UBs were inserted (the exact-context stitch of random
    DNA finds no donor and inserts nothing, as in JAX)."""
    xna = str(tmp_path / "xna")
    run = str(tmp_path / "run")
    port_cli(["train", run, *cli_data, *(f.format(xna=xna) for f in flags)])
    losses, val = _losses(run)
    assert len(losses) == 2 and np.isfinite(losses + [val]).all()


def _count_inserted(monkeypatch):
    """Wrap the train command's ``load_datasets`` so that the UBs in the
    batches it hands the trainer are counted: {"in": n, "out": n}."""
    from xna_basecaller_tpu_torch.data import ctc_data

    seen = {"in": 0, "out": 0}
    load = ctc_data.load_datasets

    def counting(*a, augment=None, **kw):
        def wrapped(c, t, l, b, rng):
            seen["in"] += int((t > 4).sum())
            c, t = augment(c, t, l, b, rng)
            seen["out"] += int((t > 4).sum())
            return c, t
        return load(*a, augment=None if augment is None else wrapped, **kw)

    monkeypatch.setattr(ctc_data, "load_datasets", counting)
    return seen


@pytest.mark.parametrize("mode", ["fully_synth", "hybrid", "spliced",
                                  "spliced_relax"])
def test_cli_runs_the_quickrun_modes(tmp_path, cli_data, mode, monkeypatch):
    """The four modes of scripts/quickrun_matrix.py, with the XNA donor
    directory passed whenever --stitch is set; the periodic donors' five
    contexts are rare in random DNA, so only relax is sure to splice."""
    flags = {"fully_synth": ["--spike", "--fully-synth"],
             "hybrid": ["--spike"], "spliced": ["--stitch"],
             "spliced_relax": ["--stitch", "--stitch-relax"]}[mode]
    if "--stitch" in flags:
        flags += ["--xna-ctc-dir", str(tmp_path / "xna")]
    seen = _count_inserted(monkeypatch)
    run = str(tmp_path / mode)
    port_cli(["train", run, *cli_data, "--ubs", "X", "--ub-prop", "0.1",
              *flags])
    losses, val = _losses(run)
    assert np.isfinite(losses + [val]).all()
    assert seen["in"] == 0
    if mode != "spliced":
        assert seen["out"] > 0


def test_cli_profile_writes_a_trace(tmp_path, cli_data):
    import json

    port_cli(["train", str(tmp_path / "run"), *cli_data, "--spike", "--ubs",
              "X", "--profile", str(tmp_path / "prof")])
    with open(tmp_path / "prof" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train_steps" in names and "aten::cumsum" in names
    spans = [e for e in events if e.get("ph") == "X"]

    def within(name, outer):
        """Each ``name`` span lies inside an ``outer`` span of its thread."""
        outs = [o for o in spans if o["name"] == outer]
        inner = [e for e in spans if e["name"] == name]
        return inner and all(any(
            o["tid"] == e["tid"] and o["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= o["ts"] + o["dur"] for o in outs)
            for e in inner)

    assert within("train.step", "train_steps")
    for child in ("forward", "loss", "backward", "optimizer"):
        assert within(f"train.{child}", "train.step")
    # the feed: its queue's waits, and the copies of the steps' and the
    # validation's batches
    assert within("pipeline.get_wait", "train_steps")
    assert "feed.to_device" in names
