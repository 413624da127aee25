"""The port's modified-base classifier (``mods``) against the JAX package,
on the CPU: the forward, ``fit``'s loss history, the model files both
ways, the feature extraction and the MM/ML tags, and ``basecaller
--mods-model`` FASTQ, SAM and BAM tags byte-equal to JAX's CLI's.

Tolerances (f32): logits rtol 1e-5 (atol 1e-5); ``fit``'s loss history
from the same initial weights, on JAX's batch order, rtol 1e-5 after three
epochs, and the trained weights atol 1e-5; everything else exact.
"""

import functools
import json
import zipfile
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.cli import main as jax_cli
from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu.infer import basecall as jbasecall
from xna_basecaller_tpu.mods import infer as jinfer
from xna_basecaller_tpu.mods import model as jmodel
from xna_basecaller_tpu.mods import train as jtrain
from xna_basecaller_tpu.models.crf_model import Model as JaxModel
from xna_basecaller_tpu.train import checkpoint as jckpt
from xna_basecaller_tpu_torch.cli import main as port_cli
from xna_basecaller_tpu_torch.mods import infer as tinfer
from xna_basecaller_tpu_torch.mods import model as tmodel
from xna_basecaller_tpu_torch.mods import train as ttrain

CONFIGS = {"default": {},
           "odd window, even kernel": dict(sig_window=61, kernel=4,
                                           context=2, conv1=8, conv2=12,
                                           hidden=16)}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: among the other test workers a pool of a thread
    per core spends its time waiting at each small op's barrier (this
    file's tests took 20-120x their time alone in the whole suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jmodel.init_mods_params(jax.random.key(seed), cfg))


def _sites(cfg, n=300, seed=0):
    rng = np.random.default_rng(seed)
    sig = rng.normal(size=(n, cfg.sig_window)).astype(np.float32)
    ctx = rng.integers(0, 7, size=(n, 2 * cfg.context + 1)).astype(np.int32)
    labels = rng.integers(0, 2, size=n)
    sig[labels == 1, cfg.sig_window // 2] += 2.0   # something to learn
    return sig, ctx, labels


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mods_forward_matches_jax(name):
    jcfg = jmodel.ModsConfig(**CONFIGS[name])
    cfg = tmodel.ModsConfig(**CONFIGS[name])
    params = _jax_params(jcfg)
    sig, ctx, _ = _sites(cfg, n=50)
    want = np.asarray(jmodel.mods_forward(params, sig, ctx, jcfg))
    model = tmodel.ModsModel(cfg, params, device="cpu")
    got = tmodel.mods_forward(model, sig, ctx).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the random init has JAX's shapes
    init = tmodel.init_mods_params(cfg, seed=1)
    assert {k: {kk: vv.shape for kk, vv in v.items()}
            for k, v in init.items()} == {
        k: {kk: vv.shape for kk, vv in v.items()} for k, v in params.items()}


def test_fit_loss_history_matches_jax(monkeypatch):
    cfg, jcfg = tmodel.ModsConfig(), jmodel.ModsConfig()
    sig, ctx, labels = _sites(cfg)
    jparams, jhist = jtrain.fit(jcfg, sig, ctx, labels, epochs=3, batch=64,
                                seed=3)
    monkeypatch.setattr(ttrain, "init_mods_params",
                        lambda c, seed: _jax_params(jcfg, seed))
    model, hist = ttrain.fit(cfg, sig, ctx, labels, epochs=3, batch=64,
                             seed=3, device="cpu")
    np.testing.assert_allclose(hist, jhist, rtol=1e-5)
    got = model.params()
    for layer, tree in jparams.items():
        for k, v in tree.items():
            np.testing.assert_allclose(got[layer][k], np.asarray(v),
                                       atol=1e-5, err_msg=f"{layer}.{k}")
    assert ttrain.accuracy(cfg, model, sig, ctx, labels) == pytest.approx(
        jtrain.accuracy(jcfg, jparams, sig, ctx, labels))
    assert hist[-1] < hist[0]


def _zip_members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def test_model_files_both_ways(tmp_path):
    """Each package reads the other's files; the port writes JAX's
    ``mods_config.json`` byte for byte and ``mods_weights.npz`` with JAX's
    members in JAX's order, each byte-equal (the zip's own timestamps are
    the time of writing)."""
    jcfg = jmodel.ModsConfig(motif="GATC", motif_offset=1, canonical="A",
                             mod_code="a", mod_long_name="6mA")
    params = _jax_params(jcfg)
    jmodel.save_mods_model(str(tmp_path / "jax"), jcfg, params)
    cfg, model = tmodel.load_mods_model(str(tmp_path / "jax"), device="cpu")
    assert cfg == tmodel.ModsConfig(**json.loads(
        (tmp_path / "jax" / "mods_config.json").read_text()))
    tmodel.save_mods_model(str(tmp_path / "port"), cfg, model)
    for name in ("mods_config.json",):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert _zip_members(tmp_path / "port" / "mods_weights.npz") == \
        _zip_members(tmp_path / "jax" / "mods_weights.npz")
    jcfg2, jparams2 = jmodel.load_mods_model(str(tmp_path / "port"))
    assert jcfg2 == jcfg
    for layer, tree in params.items():
        for k, v in tree.items():
            np.testing.assert_array_equal(np.asarray(jparams2[layer][k]), v)


@dataclass
class _Read:
    read_id: str
    signal: np.ndarray


def test_features_tags_and_call_mods_match_jax():
    rng = np.random.default_rng(2)
    seq = "".join(rng.choice(list("ACGTXY"), size=400))
    seq = seq[:50] + "CGCG" + seq[54:]      # adjacent sites
    moves = np.zeros(2000, bool)
    moves[np.sort(rng.choice(2000, size=len(seq), replace=False))] = True
    read = _Read("r", rng.normal(size=2000 * 5).astype(np.float32))
    cfg, jcfg = tmodel.ModsConfig(), jmodel.ModsConfig()
    sites = tinfer.find_motif_sites(seq, "CG", 0)
    np.testing.assert_array_equal(
        sites, jinfer.find_motif_sites(seq, "CG", 0))
    np.testing.assert_array_equal(tinfer.seq_to_sig_map(moves, 5, 10000),
                                  jinfer.seq_to_sig_map(moves, 5, 10000))
    for a, b in zip(tinfer.extract_features(read.signal, seq, moves, 5,
                                            sites, cfg),
                    jinfer.extract_features(read.signal, seq, moves, 5,
                                            sites, jcfg)):
        np.testing.assert_array_equal(a, b)
    probs = rng.uniform(size=len(sites)).astype(np.float32)
    assert tinfer.mm_ml_tags(seq, sites, probs, cfg) == \
        jinfer.mm_ml_tags(seq, sites, probs, jcfg)
    params = _jax_params(jcfg)
    attrs = {"sequence": seq, "moves": moves, "stride": 5}
    got = tinfer.call_mods(
        (cfg, tmodel.ModsModel(cfg, params, device="cpu")), read,
        dict(attrs), batch=7)
    want = jinfer.call_mods((jcfg, params), read, dict(attrs), batch=7)
    assert got["mods"] == want["mods"]
    assert got["mods"][0].startswith("MM:Z:C+m?,")
    assert tinfer.call_mods((cfg, None), read, {"sequence": ""}) \
        == {"sequence": ""}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A small CRF model (random weights), a mods model and two reads."""
    h5py = pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("mods")
    cfg = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2))
    (root / "model").mkdir()
    jconfig.save(cfg, str(root / "model"))
    jckpt.save_checkpoint(str(root / "model"), 1,
                          JaxModel(cfg).init(jax.random.key(0)))
    # the random CRF model calls few CG: C after Y is screened instead
    mcfg = jmodel.ModsConfig(motif="YC", motif_offset=1)
    jmodel.save_mods_model(str(root / "mods"), mcfg,
                           _jax_params(mcfg, seed=4))
    rng = np.random.default_rng(0)
    (root / "reads").mkdir()
    with h5py.File(root / "reads" / "batch0.fast5", "w") as fh:
        for i, rid in enumerate(["aaa", "bbb"]):
            g = fh.create_group(f"read_{rid}")
            g.attrs["read_id"] = rid
            raw = g.create_group("Raw")
            sig = rng.integers(460, 540, size=8000).astype(np.int16)
            sig[:300] = 900
            raw.create_dataset("Signal", data=sig)
            raw.attrs["read_number"] = i + 1
            ch = g.create_group("channel_id")
            ch.attrs["range"] = 1400.0
            ch.attrs["digitisation"] = 8192.0
            ch.attrs["offset"] = 10.0
            ch.attrs["sampling_rate"] = 4000.0
    return root


@pytest.fixture()
def f32_clis(monkeypatch):
    """Both CLIs decode in f32, where their output must be identical."""
    from xna_basecaller_tpu_torch.infer import basecall as tb
    monkeypatch.setattr(jbasecall, "basecall", functools.partial(
        jbasecall.basecall, compute_dtype=jnp.float32))
    monkeypatch.setattr(tb, "basecall", functools.partial(
        tb.basecall, compute_dtype=torch.float32))


@pytest.mark.parametrize("out", ["fastq", "fastq_qscores", "fastq_beam",
                                 "sam", "bam"])
def test_cli_mods_tags_match_jax_cli(dirs, tmp_path, capsys, f32_clis,
                                     monkeypatch, out):
    """``--mods-model``: standard output (FASTQ or SAM) byte-equal to JAX's
    CLI's, every call with its MM/ML tags; the BAM's records JAX's, but
    for ML, which the port writes as a ``B:C`` array."""
    import time
    from xna_basecaller_tpu_torch.data.bam import read_bam

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    args = [str(dirs / "model"), str(dirs / "reads"), "--chunksize", "1200",
            "--overlap", "200", "--batchsize", "4", "--mods-model",
            str(dirs / "mods")]
    # every decode path hands call_mods the moves and stride it reads
    args += {"fastq_qscores": ["--qscores"],
             "fastq_beam": ["--beam", "4"]}.get(out, [])
    if out in ("sam", "bam"):
        jax_cli(["basecaller", *args])
        calls = [line for line in capsys.readouterr().out.splitlines()]
        fasta = tmp_path / "ref.fasta"
        fasta.write_text("".join(f">t{i}\n{calls[i]}\n"
                                 for i in (1, 5)))
        args += ["--reference", str(fasta)]
        args += ["--sam"] if out == "sam" else ["--bam", "{}.bam"]

    def run(cli, name, *extra):
        cli(["basecaller", *[a.format(tmp_path / name) for a in args],
             *extra])
        return capsys.readouterr().out

    want = run(jax_cli, "jax")
    got = run(port_cli, "port", "--device", "cpu")
    assert got == want
    if out == "bam":
        # JAX's writer stores the ML array as a Z string; the port writes
        # the SAM spec's B:C array.  Otherwise the records are JAX's.
        refs, recs = read_bam(str(tmp_path / "port.bam"))
        jrefs, jrecs = read_bam(str(tmp_path / "jax.bam"))
        for r in jrecs:
            r["tags"] = [t.replace("ML:Z:C,", "ML:B:C,", 1) for t in r["tags"]]
        assert (refs, recs) == (jrefs, jrecs)
        tags = [t for r in recs for t in r["tags"]]
        assert sum(t.startswith("MM:Z:C+m?,") for t in tags) >= 2
        assert sum(t.startswith("ML:B:C,") for t in tags) >= 2
        assert not any(t.startswith("ML:Z:") for t in tags)
    else:
        assert got.count("MM:Z:C+m?,") >= 2 and got.count("ML:B:C,") >= 2


def test_cli_mods_loads_on_the_basecall_device(dirs, capsys):
    """The mods model loads where the basecaller runs; its long name and
    motif are reported as JAX reports them."""
    port_cli(["basecaller", str(dirs / "model"), str(dirs / "reads"),
              "--chunksize", "1200", "--overlap", "200", "--batchsize", "4",
              "--mods-model", str(dirs / "mods"), "--device", "cpu",
              "--max-reads", "1"])
    err = capsys.readouterr().err
    assert "> mods model: 5mC (YC)" in err
