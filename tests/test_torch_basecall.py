"""Port basecall pipeline and CLI (CPU, f32) against the JAX package: the
FASTQ must be identical on the F strand, the R strand and with
``legacy_char_stitch``, from simulated reads through ``run_basecaller``,
and from a fast5 directory through each package's ``basecaller`` CLI."""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.cli import main as jax_cli
from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu.data.simulate import simulate_reads as jax_sim
from xna_basecaller_tpu.infer import basecall as jbasecall
from xna_basecaller_tpu.models.crf_model import Model as JaxModel
from xna_basecaller_tpu.train import checkpoint as ckpt
from xna_basecaller_tpu_torch.cli import main as port_cli
from xna_basecaller_tpu_torch.data.simulate import simulate_reads
from xna_basecaller_tpu_torch.infer import basecall as tbasecall
from xna_basecaller_tpu_torch.utils.model_io import load_model

OPTS = dict(chunksize=1200, overlap=200, batchsize=4)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2))
    params = JaxModel(cfg).init(jax.random.key(0))
    d = tmp_path_factory.mktemp("model")
    jconfig.save(cfg, str(d))
    ckpt.save_checkpoint(str(d), 1, params)
    return str(d), JaxModel(cfg), params


def test_simulated_reads_are_the_jax_ones():
    a = list(simulate_reads(2, mean_len=2000, seed=9))
    b = list(jax_sim(2, mean_len=2000, seed=9))
    for r, s in zip(a, b):
        assert r.read_id == s.read_id and r.sequence == s.sequence
        np.testing.assert_array_equal(r.signal, s.signal)


@pytest.mark.parametrize("opts", [
    {}, {"reverse": True}, {"legacy_char_stitch": True},
    {"reverse": True, "legacy_char_stitch": True}])
def test_run_basecaller_fastq_matches_jax(model_dir, opts):
    d, jmodel, jparams = model_dir
    reads = list(simulate_reads(3, mean_len=3000, seed=4))
    fq_jax, fq_port = io.StringIO(), io.StringIO()
    jbasecall.run_basecaller(jmodel, jparams, iter(reads), fq_jax,
                             compute_dtype=jnp.float32, **OPTS, **opts)
    model, _ = load_model(d, device="cpu")
    stats = tbasecall.run_basecaller(model, iter(reads), fq_port,
                                     compute_dtype=torch.float32,
                                     **OPTS, **opts)
    assert stats["reads"] == 3
    assert stats["samples"] == sum(len(r.signal) for r in reads)
    assert fq_port.getvalue() == fq_jax.getvalue()
    seqs = fq_port.getvalue().split("\n")[1::4]
    assert all(len(s) > 0 and set(s) <= set("ACGTXY") for s in seqs)


def test_basecall_bf16_runs_on_cpu(model_dir):
    d, _, _ = model_dir
    model, _ = load_model(d, device="cpu")
    reads = list(simulate_reads(2, mean_len=1500, seed=5))
    out = list(tbasecall.basecall(model, iter(reads), **OPTS))
    assert [r.read_id for r, _ in out] == [r.read_id for r in reads]
    for read, attrs in out:
        assert len(attrs["sequence"]) == len(attrs["qstring"]) > 0


def test_cli_fastq_matches_jax_cli(model_dir, tmp_path, capsys,
                                   monkeypatch):
    h5py = pytest.importorskip("h5py")
    d, _, _ = model_dir
    reads_dir = tmp_path / "reads"
    reads_dir.mkdir()
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
    # both CLIs decode in f32 here, where their FASTQ must be identical
    from xna_basecaller_tpu_torch.infer import basecall as tb
    monkeypatch.setattr(jbasecall, "basecall", functools.partial(
        jbasecall.basecall, compute_dtype=jnp.float32))
    monkeypatch.setattr(tb, "basecall", functools.partial(
        tb.basecall, compute_dtype=torch.float32))
    args = [d, str(reads_dir), "--chunksize", "1200", "--overlap", "200",
            "--batchsize", "4"]
    jax_cli(["basecaller", *args])
    want = capsys.readouterr().out
    summary = tmp_path / "summary.tsv"
    port_cli(["basecaller", *args, "--device", "cpu",
              "--summary", str(summary)])
    got = capsys.readouterr().out
    assert got == want
    assert {l[1:] for l in got.splitlines() if l.startswith("@")} \
        == {"aaa", "bbb"}
    assert "read_id" in summary.read_text().splitlines()[0].split("\t")
