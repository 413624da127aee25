"""Port basecall pipeline and CLI (CPU, f32) against the JAX package: the
FASTQ must be identical on the F strand, the R strand and with
``legacy_char_stitch``, from simulated reads through ``run_basecaller``,
and from a fast5 directory through each package's ``basecaller`` CLI;
with ``--reference --save-ctc --ub-only --sam`` (the bootstrap-data phase)
the SAM text, the ctc-data files and the summary must be identical.  So
must the FASTQ of the q-score and the beam decodes (``qscores=True``,
``beam_width=4``, both strands; ``--qscores``, ``--beam 4``), and the SAM
and summary of ``--reference --sam --qscores``; ``--qscores --superbatch
2`` warns as JAX does and writes what ``--qscores`` writes; ``--profile``
writes a trace."""

import functools
import io
import json
import os

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
from xna_basecaller_tpu_torch.data import chunkops
from xna_basecaller_tpu_torch.data.simulate import (
    self_reference, simulate_reads,
)
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


@pytest.mark.parametrize("opts", [
    {"qscores": True}, {"qscores": True, "reverse": True},
    {"beam_width": 4}, {"beam_width": 4, "reverse": True},
    {"qscores": True, "beam_width": 4}])
def test_run_basecaller_qscores_and_beam_match_jax(model_dir, opts):
    """The q-score decode (real qualities) and the beam decode through
    ``run_basecaller``: FASTQ identical to JAX's (with both, the q-score
    decode runs, as in JAX)."""
    d, jmodel, jparams = model_dir
    reads = list(simulate_reads(3, mean_len=3000, seed=6))
    fq_jax, fq_port = io.StringIO(), io.StringIO()
    jbasecall.run_basecaller(jmodel, jparams, iter(reads), fq_jax,
                             compute_dtype=jnp.float32, **OPTS, **opts)
    model, _ = load_model(d, device="cpu")
    tbasecall.run_basecaller(model, iter(reads), fq_port,
                             compute_dtype=torch.float32, **OPTS, **opts)
    assert fq_port.getvalue() == fq_jax.getvalue()
    lines = fq_port.getvalue().split("\n")
    seqs, quals = lines[1::4], lines[3::4]
    assert all(len(s) == len(q) > 0 for s, q in zip(seqs, quals))
    if opts.get("qscores"):
        assert any(set(q) - {"O"} for q in quals)


def test_basecall_refuses_superbatches_without_qscores_or_beam(model_dir,
                                                               capsys):
    """Superbatches are ported: ``superbatch=2`` alone calls what 1 calls,
    without a warning; with a beam (or ``qscores``) it still runs as 1,
    with JAX's warning."""
    d, _, _ = model_dir
    model, _ = load_model(d, device="cpu")
    reads = list(simulate_reads(1, mean_len=1500, seed=5))
    one = list(tbasecall.basecall(model, iter(reads), **OPTS))
    two = list(tbasecall.basecall(model, iter(reads), superbatch=2, **OPTS))
    assert [a["sequence"] for _, a in two] == [a["sequence"] for _, a in one]
    assert "ignored" not in capsys.readouterr().err
    out = list(tbasecall.basecall(model, iter(reads), superbatch=3,
                                  beam_width=2, **OPTS))
    assert len(out) == 1
    assert "--superbatch 3 ignored (runs as 1): qscores/beam decoding is " \
        "not superbatched" in capsys.readouterr().err


@pytest.mark.parametrize("G", [2, 3])
def test_run_basecaller_superbatch_matches_jax(model_dir, G, monkeypatch):
    """``superbatch=G`` (3: a partial trailing group, padded with empty
    batches) in f32: the FASTQ equal to ``superbatch=1``'s and to JAX's
    ``superbatch=G``; each real batch is computed once, the padding not."""
    d, jmodel, jparams = model_dir
    reads = list(simulate_reads(4, mean_len=3000, seed=4))
    fq_jax, fq_one, fq_g = io.StringIO(), io.StringIO(), io.StringIO()
    jbasecall.run_basecaller(jmodel, jparams, iter(reads), fq_jax,
                             compute_dtype=jnp.float32, superbatch=G, **OPTS)
    model, _ = load_model(d, device="cpu")
    tbasecall.run_basecaller(model, iter(reads), fq_one,
                             compute_dtype=torch.float32, **OPTS)
    calls = []
    forward = tbasecall._forward
    monkeypatch.setattr(tbasecall, "_forward", lambda m, x, *a: (
        calls.append(x.shape), forward(m, x, *a))[1])
    tbasecall.run_basecaller(model, iter(reads), fq_g,
                             compute_dtype=torch.float32, superbatch=G,
                             **OPTS)
    assert fq_g.getvalue() == fq_one.getvalue() == fq_jax.getvalue()
    n_chunks = sum(len(chunkops.chunk(r.signal, 1200, 200)) for r in reads)
    assert len(calls) == -(-n_chunks // OPTS["batchsize"])
    # 4 batches: G = 3 pads its trailing group with 2 empty batches
    assert (len(calls) % G != 0) == (G == 3)


def test_basecall_bf16_runs_on_cpu(model_dir):
    d, _, _ = model_dir
    model, _ = load_model(d, device="cpu")
    reads = list(simulate_reads(2, mean_len=1500, seed=5))
    out = list(tbasecall.basecall(model, iter(reads), **OPTS))
    assert [r.read_id for r, _ in out] == [r.read_id for r in reads]
    for read, attrs in out:
        assert len(attrs["sequence"]) == len(attrs["qstring"]) > 0


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


@pytest.fixture()
def f32_clis(monkeypatch):
    """Both CLIs decode in f32, where their output must be identical."""
    from xna_basecaller_tpu_torch.infer import basecall as tb
    monkeypatch.setattr(jbasecall, "basecall", functools.partial(
        jbasecall.basecall, compute_dtype=jnp.float32))
    monkeypatch.setattr(tb, "basecall", functools.partial(
        tb.basecall, compute_dtype=torch.float32))


def test_cli_fastq_matches_jax_cli(model_dir, fast5_dir, tmp_path, capsys,
                                   f32_clis):
    d, _, _ = model_dir
    args = [d, fast5_dir, "--chunksize", "1200", "--overlap", "200",
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


def test_cli_bootstrap_data_matches_jax_cli(model_dir, fast5_dir, tmp_path,
                                            capsys, f32_clis):
    """Phase B of the paper's chain through both CLIs: chunk-reads called,
    aligned to a reference made from JAX's own calls of them, SAM on
    stdout, ctc-data of the kept chunks and the summary with its
    alignment columns.  The SAM text, every file of the ctc directory and
    the summary TSV are identical."""
    from xna_basecaller_tpu.data.fast5 import get_reads, read_chunks

    d, jmodel, jparams = model_dir
    chunks = [c for r in get_reads(fast5_dir, n_proc=1)
              for c in read_chunks(r, chunksize=1200, overlap=200)]
    calls = {r.read_id: a["sequence"] for r, a in jbasecall.basecall(
        jmodel, jparams, iter(chunks), compute_dtype=jnp.float32, **OPTS)}
    fasta = tmp_path / "ref.fasta"
    n_templates = self_reference(calls.values(), fasta)
    assert n_templates >= 4

    def run(cli, name, *extra):
        args = [d, fast5_dir, "--chunksize", "1200", "--overlap", "200",
                "--batchsize", "4", "--reference", str(fasta), "--save-ctc",
                str(tmp_path / name), "--ub-only", "--sam", "--read-group",
                "X", "--summary", str(tmp_path / f"{name}.tsv"),
                # the random model's calls are half X/Y, which no template
                # base matches: accuracy ~0.5 where they align
                "--ctc-min-accuracy", "0.4", "--ctc-min-coverage", "0.8"]
        cli(["basecaller", *args, *extra])
        return capsys.readouterr().out

    want = run(jax_cli, "jax")
    got = run(port_cli, "port", "--device", "cpu")
    assert got == want
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert "chunks.npy" in files and "filter_stats.csv" in files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() \
            == (tmp_path / "jax" / f).read_bytes(), f
    assert (tmp_path / "port.tsv").read_text() \
        == (tmp_path / "jax.tsv").read_text()

    records = [l.split("\t") for l in got.splitlines()
               if not l.startswith("@")]
    assert len(records) == sum(1 for s in calls.values() if s)
    assert {r[0] for r in records} <= set(calls)
    assert all(r[-1] == "RG:Z:X" for r in records)
    assert {r[1] for r in records} == {"0", "4", "16"}
    refs = np.load(tmp_path / "port" / "references.npy")
    assert len(refs) > 0 and ((refs == 5) | (refs == 6)).any(axis=1).all()
    assert {5, 6} <= set(np.unique(refs).tolist())
    # the chunks kept are f16 copies of chunk-reads' signal
    kept = np.load(tmp_path / "port" / "chunks.npy")
    signals = {c.signal.astype(np.float16).tobytes() for c in chunks}
    assert all(k.tobytes() in signals for k in kept)
    with open(tmp_path / "port" / "filter_stats.csv") as fh:
        stats = dict(line.strip().split(",") for line in fh)
    failed = sum(int(stats[k]) for k in (
        "count_failed_seq", "count_failed_map", "non_ubs_skipped",
        "count_failed_acc", "count_failed_cov")) \
        - int(stats["count_failed_both"])
    assert failed + len(kept) == len(chunks)


def test_cli_save_ctc_needs_a_reference(model_dir, fast5_dir, tmp_path,
                                        capsys):
    d, _, _ = model_dir
    args = [d, fast5_dir, "--save-ctc", str(tmp_path / "ctc")]
    for cli, extra in ((jax_cli, []), (port_cli, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            cli(["basecaller", *args, *extra])
        assert exc.value.code == 1
        assert "a reference is needed" in capsys.readouterr().err
    assert not (tmp_path / "ctc").exists()


@pytest.mark.parametrize("flags", [["--qscores"], ["--beam", "4"],
                                   ["--qscores", "--revcomp"]])
def test_cli_qscores_and_beam_match_jax_cli(model_dir, fast5_dir, flags,
                                            capsys, f32_clis):
    d, _, _ = model_dir
    args = [d, fast5_dir, "--chunksize", "1200", "--overlap", "200",
            "--batchsize", "4", *flags]
    jax_cli(["basecaller", *args])
    want = capsys.readouterr().out
    port_cli(["basecaller", *args, "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert want.count("\n") == 8


def test_cli_qscores_superbatch_warns_and_calls_as_without(
        model_dir, fast5_dir, capsys, f32_clis):
    """``--qscores --superbatch 2``: JAX's warning on stderr, and the
    output of ``--qscores`` alone (in both packages)."""
    d, _, _ = model_dir
    args = [d, fast5_dir, "--chunksize", "1200", "--overlap", "200",
            "--batchsize", "4", "--qscores"]
    port_cli(["basecaller", *args, "--device", "cpu"])
    alone = capsys.readouterr().out
    outs = []
    for cli, extra in ((jax_cli, []), (port_cli, ["--device", "cpu"])):
        cli(["basecaller", *args, "--superbatch", "2", *extra])
        out, err = capsys.readouterr()
        outs.append(out)
        assert "[basecall] --superbatch 2 ignored (runs as 1): " \
            "qscores/beam decoding is not superbatched" in err
    assert outs == [alone, alone]


def test_cli_sam_with_qscores_matches_jax_cli(model_dir, fast5_dir,
                                              tmp_path, capsys, f32_clis):
    """``--reference --sam --qscores --summary``: the SAM (its QUAL column
    the real qualities) and the summary (its mean_qscore from them)
    identical to JAX's."""
    from xna_basecaller_tpu.data.fast5 import get_reads
    from xna_basecaller_tpu_torch.data.writers import (
        mean_qscore_from_qstring,
    )

    d, jmodel, jparams = model_dir
    calls = [a["sequence"] for _, a in jbasecall.basecall(
        jmodel, jparams, get_reads(fast5_dir, n_proc=1),
        compute_dtype=jnp.float32, **OPTS)]
    fasta = tmp_path / "ref.fasta"
    self_reference(calls, fasta)

    def run(cli, name, *extra):
        summary = tmp_path / f"{name}.tsv"
        cli(["basecaller", d, fast5_dir, "--chunksize", "1200",
             "--overlap", "200", "--batchsize", "4", "--reference",
             str(fasta), "--sam", "--qscores", "--summary", str(summary),
             *extra])
        return capsys.readouterr().out, summary.read_text()

    want = run(jax_cli, "jax")
    got = run(port_cli, "port", "--device", "cpu")
    assert got == want
    records = [ln.split("\t") for ln in got[0].splitlines()
               if not ln.startswith("@")]
    assert len(records) == 2 and all(set(r[10]) - {"O"} for r in records)
    header, *rows = [ln.split("\t") for ln in got[1].splitlines()]
    q = header.index("mean_qscore_template")
    assert len(rows) == 2 and [float(r[q]) for r in rows] == [
        mean_qscore_from_qstring(r[10]) for r in records]


def test_cli_profile_writes_a_trace(model_dir, fast5_dir, tmp_path, capsys):
    d, _, _ = model_dir
    trace_dir = tmp_path / "prof"
    port_cli(["basecaller", d, fast5_dir, "--chunksize", "1200",
              "--overlap", "200", "--batchsize", "4", "--device", "cpu",
              "--profile", str(trace_dir)])
    out, err = capsys.readouterr()
    assert out.count("\n") == 8
    trace = trace_dir / "trace.json"
    assert f"> profile trace: {trace}" in err
    assert json.loads(trace.read_text())["traceEvents"]


@pytest.fixture()
def self_ref(model_dir, fast5_dir, tmp_path):
    """A reference made of JAX's calls of the fast5 reads."""
    from xna_basecaller_tpu.data.fast5 import get_reads

    _, jmodel, jparams = model_dir
    calls = [a["sequence"] for _, a in jbasecall.basecall(
        jmodel, jparams, get_reads(fast5_dir, n_proc=1),
        compute_dtype=jnp.float32, **OPTS)]
    fasta = tmp_path / "ref.fasta"
    self_reference(calls, fasta)
    return str(fasta)


@pytest.mark.parametrize("case", [
    "superbatch_2", "superbatch_3", "reference_bam", "cram",
    "reference_bam_cram_sam", "reference_cram_ensemble"])
def test_cli_binary_outputs_and_superbatch_match_jax_cli(
        model_dir, fast5_dir, self_ref, tmp_path, capsys, f32_clis,
        monkeypatch, case):
    """``--superbatch G``, ``--reference --bam``, ``--cram`` and both with
    ``--sam`` (standard output: FASTQ only when no binary writer is set and
    ``--sam`` is off), and a two-member ensemble (its read group the first
    member's directory): standard output and every file byte-equal to
    JAX's CLI's.  The CRAM's gzip blocks carry the clock's time, pinned."""
    import shutil
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    d, _, _ = model_dir
    if case.endswith("ensemble"):
        d2 = tmp_path / "member2"
        shutil.copytree(d, d2)
        d = f"{d},{d2}"
    flags = {
        "superbatch_2": ["--superbatch", "2"],
        "superbatch_3": ["--superbatch", "3"],
        "reference_bam": ["--reference", self_ref, "--bam", "{}.bam"],
        "cram": ["--cram", "{}.cram"],
        "reference_bam_cram_sam": ["--reference", self_ref, "--sam", "--bam",
                                   "{}.bam", "--cram", "{}.cram"],
        "reference_cram_ensemble": ["--reference", self_ref, "--cram",
                                    "{}.cram"]}[case]

    def run(cli, name, *extra):
        out = [f.format(tmp_path / name) for f in flags]
        cli(["basecaller", d, fast5_dir, "--chunksize", "1200", "--overlap",
             "200", "--batchsize", "4", *out, *extra])
        files = {f[-4:]: open(f, "rb").read() for f in out
                 if f.endswith((".bam", ".cram"))}
        return capsys.readouterr().out, files

    want = run(jax_cli, "jax")
    got = run(port_cli, "port", "--device", "cpu")
    assert got == want
    stdout, files = got
    if case.startswith("superbatch"):
        assert stdout.count("\n") == 8
    else:
        assert ("@HD" in stdout) == ("--sam" in flags)
        assert "@aaa" not in stdout and files
    if ".cram" in files:
        from xna_basecaller_tpu_torch.data.cram import read_cram
        path = tmp_path / "port.cram"
        header, recs = read_cram(str(path))
        assert sorted(r["read_id"] for r in recs) == ["aaa", "bbb"]
        first = os.path.basename(os.path.normpath(d.split(",")[0]))
        assert all(r["tags"] == [f"RG:Z:{first}"] for r in recs)
    if ".bam" in files:
        from xna_basecaller_tpu_torch.data.bam import read_bam
        _, recs = read_bam(str(tmp_path / "port.bam"))
        assert sorted(r["query_name"] for r in recs) == ["aaa", "bbb"]


def test_cli_bam_needs_a_reference(model_dir, fast5_dir, tmp_path):
    d, _, _ = model_dir
    msgs = []
    for cli, extra in ((jax_cli, []), (port_cli, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            cli(["basecaller", d, fast5_dir, "--bam", str(tmp_path / "x.bam"),
                 *extra])
        msgs.append(exc.value.code)
    assert msgs == ["--bam requires --reference"] * 2
    assert not (tmp_path / "x.bam").exists()
