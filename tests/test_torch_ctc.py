"""The port's legacy CTC (QuartzNet) family against the JAX package, on
the CPU: the model's log-probs, the CTC loss and its gradient, the
decoders, one ``train_step``, ``weights_N.npz`` both ways, the Trainer and
the ``train`` CLI on a ``[[block]]`` config, ``basecall_ctc`` and the
``basecaller`` CLI's FASTQ.

Tolerances (f32): log-probs rtol 1e-5 (atol 1e-5, the scale of a
log-prob's rounding near 0); the loss rel 1e-5 and its gradient (through
the log-softmax, as the model takes it) 1e-4 of the largest element; one
train_step: loss rel 1e-5, grad_norm rel 1e-4, parameters atol 2e-6 for
all but 0.1% of each tensor (AdamW's first step moves an element by about
lr whatever its gradient, so a gradient within rounding of zero may take
either sign; see test_torch_train.py), the batchnorm running stats rtol
1e-5; the greedy posteriors within an ulp (rtol 2e-7: torch's exp and
XLA's); the decodes and the FASTQ exact.
"""

import io
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.cli import main as jax_cli
from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import BlockConfig, ModelConfig
from xna_basecaller_tpu.infer import ctc_basecall as jbasecall
from xna_basecaller_tpu.models import ctc_model as jctc
from xna_basecaller_tpu.ops import ctc as jops
from xna_basecaller_tpu.train import checkpoint as jckpt
from xna_basecaller_tpu.train import loop as jloop
from xna_basecaller_tpu.utils.model_io import load_model as jax_load_model
from xna_basecaller_tpu_torch.cli import main as port_cli
from xna_basecaller_tpu_torch.core import config as tconfig
from xna_basecaller_tpu_torch.data.ctc_data import ChunkDataset
from xna_basecaller_tpu_torch.infer import ctc_basecall as tbasecall
from xna_basecaller_tpu_torch.models import ctc_model as tctc
from xna_basecaller_tpu_torch.ops import ctc as tops
from xna_basecaller_tpu_torch.train import checkpoint as ckpt
from xna_basecaller_tpu_torch.train.loop import Trainer, make_optimizer
from xna_basecaller_tpu_torch.utils.model_io import load_model
from xna_basecaller_tpu_torch.utils.weights import (
    params_from_jax, params_to_jax,
)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: among the other test workers a pool of a thread
    per core spends its time waiting at each small op's barrier (this
    file's tests took 20-120x their time alone in the whole suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dilation=1, dropout=0.05, labels="NACGT"):
    blocks = (
        BlockConfig(filters=16, repeat=1, kernel=(9,), stride=(3,)),
        BlockConfig(filters=16, repeat=3, kernel=(7,), residual=True,
                    separable=True, dropout=dropout,
                    dilation=(dilation,)),
        BlockConfig(filters=32, repeat=1, kernel=(1,)),
    )
    return ModelConfig(labels=tuple(labels), blocks=blocks,
                       package="xna_basecaller_tpu.models.ctc_model")


def _port_cfg(cfg):
    return tconfig.from_dict(jconfig.to_dict(cfg))


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt._flatten(tree).items()}


def _params(cfg, seed=0, stats=True):
    """JAX's initial parameters, with batchnorm stats away from 0 / 1."""
    params = jctc.init_params(jax.random.key(seed), cfg)
    if not stats:
        return params
    flat = _flat(params)
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    return jckpt._unflatten(params, flat)


def _port_model(cfg, params):
    model = tctc.CtcModel(_port_cfg(cfg), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(_flat(params)))
    return model


@pytest.mark.parametrize("dilation", [1, 2])
def test_log_probs_match_jax(dilation):
    cfg = _cfg(dilation=dilation)
    params = _params(cfg)
    sig = np.random.default_rng(1).normal(size=(3, 330)).astype(np.float32)
    want = np.asarray(jctc.forward(params, sig, cfg))
    got = _port_model(cfg, params)(torch.from_numpy(sig))
    assert got.shape == want.shape == (110, 3, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_quartznet5x5_config_equals_jax():
    assert tctc.quartznet5x5_config("NACGTXY") == _port_cfg(
        jctc.quartznet5x5_config("NACGTXY"))
    model = tctc.CtcModel(tctc.quartznet5x5_config(), device="meta",
                          seed=None)
    assert model.stride == 3
    jparams = jax.eval_shape(lambda: jctc.init_params(
        jax.random.key(0), jctc.quartznet5x5_config()))
    assert model.n_params() == sum(
        int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))


def _problem(seed=0, T=40, N=4, C=5, L=8):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, N, C)).astype(np.float32)
    lengths = rng.integers(2, L + 1, size=N).astype(np.int32)
    targets = np.zeros((N, L), np.int32)
    for n in range(N):
        targets[n, :lengths[n]] = rng.integers(1, C, size=lengths[n])
    targets[0, :4] = [1, 1, 2, 2]      # repeats: the skip rule
    lengths[0] = max(lengths[0], 4)
    return logits, targets, lengths


def test_ctc_loss_and_gradient_match_jax():
    logits, targets, lengths = _problem()

    def jax_loss(x):
        lp = jax.nn.log_softmax(x, axis=-1)
        return jops.ctc_label_smoothing_loss(
            lp, jnp.asarray(targets), jnp.asarray(lengths))["loss"]
    want, g_want = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    lp = torch.log_softmax(x, -1)
    got = tops.ctc_label_smoothing_loss(
        lp, torch.from_numpy(targets), torch.from_numpy(lengths))
    got["loss"].backward()
    np.testing.assert_allclose(got["loss"].item(), float(want), rtol=1e-5)
    g_want = np.asarray(g_want)
    np.testing.assert_allclose(x.grad.numpy(), g_want, rtol=0,
                               atol=1e-4 * np.abs(g_want).max())
    lp_j = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    for red in ("none", "mean", "sum"):
        np.testing.assert_allclose(
            tops.ctc_loss(lp.detach(), torch.from_numpy(targets),
                          torch.from_numpy(lengths), reduction=red).numpy(),
            np.asarray(jops.ctc_loss(lp_j, jnp.asarray(targets),
                                     jnp.asarray(lengths), reduction=red)),
            rtol=1e-5)


def test_greedy_collapse_and_beam_match_jax():
    logits, _, _ = _problem(seed=2, T=60, N=3)
    lp_j = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    lp = torch.from_numpy(np.array(lp_j))
    paths_j, probs_j = jops.greedy_paths(lp_j)
    paths, probs = tops.greedy_paths(lp)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(paths_j))
    # exp of the same f32 values: within an ulp of JAX's
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_j),
                               rtol=2e-7)
    for p, q in zip(paths.numpy(), probs.numpy()):
        got = tops.collapse_path(p, q, qscale=1.1, qbias=0.5)
        want = jops.collapse_path(p, q, qscale=1.1, qbias=0.5)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
    for row in np.exp(np.asarray(lp_j)).transpose(1, 0, 2):
        for beam in (1, 3, 8):
            got = tops.beam_search(row, "NACGT", beam)
            want = jops.beam_search(row, "NACGT", beam)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            py = tops._beam_search_py(row, "NACGT", beam, 1e-3)
            assert py[0] == want[0]


@pytest.mark.parametrize("reverse", [False, True])
def test_log_softmax_scores_matches_jax(reverse):
    # f32 log_softmax of the same logits: rtol 1e-6 of JAX's
    logits, _, _ = _problem(seed=4, T=40, N=3)
    want = np.asarray(jops.log_softmax_scores(jnp.asarray(logits),
                                              reverse=reverse))
    got = tops.log_softmax_scores(torch.from_numpy(logits), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _batch(n=6, T_sig=330, L=20, seed=3):
    rng = np.random.default_rng(seed)
    chunks = rng.normal(size=(n, T_sig)).astype(np.float32)
    lengths = rng.integers(5, L + 1, size=n).astype(np.int32)
    targets = np.zeros((n, L), np.int32)
    for i in range(n):
        targets[i, :lengths[i]] = rng.integers(1, 5, size=lengths[i])
    return chunks, targets, lengths


def test_train_step_matches_jax():
    cfg = _cfg()
    params = _params(cfg)
    c, t, l = _batch()
    l[-1] = 0                     # a padding row, masked out of the mean
    model = _port_model(cfg, params)
    opt_j = jloop.make_optimizer(lambda _: 1e-3)
    p_j, _, loss_j, gn_j = jctc.train_step(
        jax.tree.map(jnp.array, params), opt_j.init(params),
        jnp.asarray(c), jnp.asarray(t), jnp.asarray(l), cfg, opt_j)
    loss, gn = tctc.train_step(model, make_optimizer(model, lambda _: 1e-3),
                               *(torch.from_numpy(a) for a in (c, t, l)))
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(gn.item(), float(gn_j), rtol=1e-4)
    want = _flat(p_j)
    got = params_to_jax(model.state_dict())
    assert set(got) == set(want)
    for k, v in got.items():
        if k.endswith(("/mean", "/var")):
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            assert not np.array_equal(v, _flat(params)[k]), k
            continue
        diff = np.abs(v - want[k])
        assert (diff > 2e-6).mean() <= 1e-3, k
        assert diff.max() <= 2.2e-3, k


def test_weights_npz_both_ways(tmp_path):
    cfg = _cfg()
    params = _params(cfg)
    a, b = tmp_path / "jax", tmp_path / "port"
    for d in (a, b):
        d.mkdir()
        jconfig.save(cfg, str(d))
    jckpt.save_checkpoint(str(a), 1, params)
    model, tcfg = load_model(str(a), device="cpu")
    assert isinstance(model, tctc.CtcModel) and tcfg.is_ctc
    ckpt.save_checkpoint(str(b), 1, params_to_jax(model.state_dict()))
    _, back, _ = jax_load_model(str(b))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(back)[k], v, err_msg=k)
    # skip_top keeps the decoder's fresh initialisation
    top, _ = load_model(str(a), device="cpu", skip_top=True, seed=5)
    fresh = tctc.CtcModel(tcfg, device="cpu", seed=5)
    assert torch.equal(top.decoder.w, fresh.decoder.w)
    assert torch.equal(top.blocks[0].convs[0].tcs.conv.w,
                       model.blocks[0].convs[0].tcs.conv.w)


def test_trainer_matches_jax_and_writes_jax_files(tmp_path):
    """One epoch without dropout from the same weights: the losses and the
    validation as JAX's Trainer gives them; the checkpoint and the
    optimizer file keyed and shaped as JAX's."""
    from xna_basecaller_tpu.data.ctc_data import ChunkDataset as JChunks
    cfg = _cfg(dropout=0.0)
    params = _params(cfg, stats=False)
    c, t, l = _batch(24, seed=4)
    kw = dict(batchsize=8, lr=1e-3, warmup_steps=2, save_optim_every=1,
              log=lambda *a: None)
    model = _port_model(cfg, params)    # JAX's fit donates params
    jres = jloop.Trainer(jctc.CtcModel(cfg), JChunks(c[:16], t[:16], l[:16]),
                         JChunks(c[16:], t[16:], l[16:]),
                         initial_params=params, **kw).fit(
        str(tmp_path / "jax"), epochs=1)
    train = ChunkDataset(c[:16], t[:16], l[:16])
    valid = ChunkDataset(c[16:], t[16:], l[16:])
    res = Trainer(model, train, valid, **kw).fit(
        str(tmp_path / "port"), epochs=1)
    got, want = res["history"][0], jres["history"][0]
    for key in ("train_loss", "validation_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    for name in ("weights_1.npz", "optim_1.npz"):
        a = ckpt.load_flat(str(tmp_path / "port" / name))
        b = ckpt.load_flat(str(tmp_path / "jax" / name))
        assert sorted(a) == sorted(b), name
        assert all(a[k].shape == b[k].shape for k in a), name


def test_train_cli_trains_a_block_config(tmp_path):
    from xna_basecaller_tpu_torch.data.ctc_data import save_ctc_data
    cfg = _cfg()
    tconfig.save(_port_cfg(cfg), str(tmp_path / "ctc.toml"))
    c, t, l = _batch(40, seed=6)
    save_ctc_data(str(tmp_path / "data"), c, t.astype(np.uint8), l)
    run = tmp_path / "run"
    port_cli(["train", str(run), "--directory", str(tmp_path / "data"),
              "--config", str(tmp_path / "ctc.toml"), "--epochs", "1",
              "--batch", "8", "--device", "cpu"])
    model, tcfg = load_model(str(run), device="cpu")
    assert isinstance(model, tctc.CtcModel)
    start = tctc.CtcModel(tcfg, device="cpu", seed=25)
    bn, bn0 = model.blocks[1].convs[0].bn, start.blocks[1].convs[0].bn
    assert not torch.equal(bn.mean, bn0.mean)
    assert not torch.equal(bn.var, bn0.var)
    assert (run / "losses_1.csv").exists()
    # JAX's own CLI builds the CRF model of any config, and its Trainer
    # then fails on a [[block]] config; JAX loads the port's checkpoint
    _, p, jcfg = jax_load_model(str(run))
    assert jcfg.is_ctc and "blocks" in p


@dataclass
class _Read:
    read_id: str
    signal: np.ndarray


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = _cfg()
    params = _params(cfg)
    d = tmp_path_factory.mktemp("ctc_model")
    jconfig.save(cfg, str(d))
    jckpt.save_checkpoint(str(d), 1, params)
    return str(d), cfg, params


@pytest.mark.parametrize("beamsize", [1, 3])
def test_basecall_ctc_matches_jax(model_dir, beamsize):
    d, cfg, params = model_dir
    rng = np.random.default_rng(3)
    reads = [_Read(f"r{i}", rng.normal(size=n).astype(np.float32))
             for i, n in enumerate([700, 450, 900])]
    opts = dict(chunksize=300, overlap=60, batchsize=4, beamsize=beamsize)
    want = list(jbasecall.basecall_ctc(jctc.CtcModel(cfg), params,
                                       iter(reads), **opts))
    model, _ = load_model(d, device="cpu")
    got = list(tbasecall.basecall_ctc(model, iter(reads), **opts))
    assert [r.read_id for r, _ in got] == ["r0", "r1", "r2"]
    for (_, a), (_, b) in zip(got, want):
        for k in ("sequence", "qstring", "mean_qscore", "stride"):
            assert a[k] == b[k], k
        for k in ("moves", "sig_move"):
            np.testing.assert_array_equal(a[k], b[k])
    fq_j, fq = io.StringIO(), io.StringIO()
    jbasecall.run_ctc_basecaller(jctc.CtcModel(cfg), params, iter(reads),
                                 fq_j, beamsize=beamsize, chunksize=300,
                                 overlap=60, batchsize=4)
    stats = tbasecall.run_ctc_basecaller(model, iter(reads), fq,
                                         beamsize=beamsize, chunksize=300,
                                         overlap=60, batchsize=4)
    assert fq.getvalue() == fq_j.getvalue() and stats["reads"] == 3


@pytest.fixture(scope="module")
def fast5_dir(tmp_path_factory):
    """Two reads of 6000 samples in one fast5 file."""
    h5py = pytest.importorskip("h5py")
    reads_dir = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(0)
    with h5py.File(reads_dir / "batch0.fast5", "w") as fh:
        for i, rid in enumerate(["aaa", "bbb"]):
            g = fh.create_group(f"read_{rid}")
            g.attrs["read_id"] = rid
            raw = g.create_group("Raw")
            sig = rng.integers(460, 540, size=6000).astype(np.int16)
            sig[:300] = 900
            raw.create_dataset("Signal", data=sig)
            raw.attrs["read_number"] = i + 1
            ch = g.create_group("channel_id")
            ch.attrs["range"] = 1400.0
            ch.attrs["digitisation"] = 8192.0
            ch.attrs["offset"] = 10.0
            ch.attrs["sampling_rate"] = 4000.0
    return str(reads_dir)


@pytest.mark.parametrize("flags", [["--beamsize", "1"], ["--beamsize", "4"],
                                   ["--qscores"]])
def test_cli_fastq_matches_jax_cli(model_dir, fast5_dir, tmp_path, capsys,
                                   flags):
    d, _, _ = model_dir
    args = [d, fast5_dir, "--chunksize", "1200", "--overlap", "200",
            "--batchsize", "4", *flags]
    jax_cli(["basecaller", *args, "--summary", str(tmp_path / "j.tsv")])
    want = capsys.readouterr().out
    port_cli(["basecaller", *args, "--device", "cpu", "--summary",
              str(tmp_path / "p.tsv")])
    got = capsys.readouterr().out
    assert got == want
    assert {x[1:] for x in got.splitlines() if x.startswith("@")} \
        == {"aaa", "bbb"}
    assert (tmp_path / "p.tsv").read_text() == (tmp_path / "j.tsv") \
        .read_text()


def test_cli_refuses_ctc_ensembles(model_dir, fast5_dir, capsys):
    d, _, _ = model_dir
    with pytest.raises(SystemExit) as exc:
        port_cli(["basecaller", f"{d},{d}", fast5_dir, "--device", "cpu"])
    assert exc.value.code == 1
    assert "ensembles are CRF-only" in capsys.readouterr().err
