"""The port's evaluation chain against the JAX package's, on the CPU:
``consolidate_ub_validation`` (the same best epoch and symlinks, the
per-epoch table as pandas reads it), ``eval_model`` on a FASTQ (the PAF
and every CSV byte-equal, the summary equal), ``basecall_and_eval`` with a
small model (2 layers, 64 features) carried across in JAX's checkpoint
layout, in f32 (the FASTQ byte-equal, the summary equal), checkpoint
ensembles (two members: the FASTQ byte-equal to JAX's decode of the
``params`` list; ``[m, m]`` equal to ``m``), both also with the beam
decode (``beam_width=4``), and ``train_and_eval``'s
orchestration as ``tests/test_train_and_eval.py`` drives JAX's."""

import filecmp
import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.alphabet import reverse_complement_str
from xna_basecaller_tpu.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu.data.simulate import sim_library_reads
from xna_basecaller_tpu.eval.xna_refs import XnaRefs as JXnaRefs
from xna_basecaller_tpu.infer import basecall as jbasecall
from xna_basecaller_tpu.models.crf_model import Model as JaxModel
from xna_basecaller_tpu.tools import consolidate_ub_validation as jcons
from xna_basecaller_tpu.tools import eval_model as jeval
from xna_basecaller_tpu.train import checkpoint as jckpt
from xna_basecaller_tpu_torch.data.writers import write_fastq
from xna_basecaller_tpu_torch.infer import basecall as tbasecall
from xna_basecaller_tpu_torch.tools import consolidate_ub_validation as cons
from xna_basecaller_tpu_torch.tools import eval_model
from xna_basecaller_tpu_torch.tools.train_and_eval import (
    run_ub_validation, train_and_eval,
)
from xna_basecaller_tpu_torch.utils.model_io import load_model

QUIET = dict(log=lambda *a: None)


def _same_tree(a, b):
    """Every file of two directories byte-equal, symlinks to the same
    targets."""
    names = sorted(os.listdir(a))
    assert sorted(os.listdir(b)) == names
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.islink(pa):
            assert os.readlink(pa) == os.readlink(pb), n
        elif os.path.isdir(pa):
            _same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n


# per epoch: (err_only_ub, err_far_ub); None writes no summary
EPOCHS = {
    "distinct": {1: (20.0, 5.0), 2: (10.0, 6.0), 3: (15.0, 1.0)},
    "tie on err_far_ub": {1: (10.0, 5.0), 2: (12.0, 1.0), 4: (10.0, 2.0),
                          10: (10.0, 3.0)},
    "nan and a missing epoch": {1: (float("nan"), 1.0), 2: (30.0, 2.0),
                                3: None, 5: (30.0, float("nan"))},
    "none": {1: None},
}


def _epoch_dirs(root, epochs):
    os.makedirs(root)
    for e, vals in epochs.items():
        open(os.path.join(root, f"weights_{e}.npz"), "w").close()
        d = os.path.join(root, f"basecalls-weights_{e}")
        os.makedirs(d)
        if vals is None:
            continue
        pd.DataFrame([{"num_aligned_reads": 7 + e, "err_only_ub": vals[0],
                       "err_close_ub": 3.25, "err_far_ub": vals[1],
                       "oracle_demux": e % 2 == 0}]).to_csv(
            os.path.join(d, "results_summ-POC-val.csv"), index=False,
            na_rep="nan", float_format="{:.3f}".format)


@pytest.mark.parametrize("case", list(EPOCHS))
@pytest.mark.parametrize("exp", ["POC", None])
def test_consolidate_ub_validation_equals_jax(tmp_path, case, exp):
    runs = {}
    for name, mod in (("jax", jcons), ("port", cons)):
        root = str(tmp_path / name)
        _epoch_dirs(root, EPOCHS[case])
        runs[name] = (root, mod.consolidate_ub_validation(
            root, exp=exp, **QUIET))
    assert runs["port"][1] == runs["jax"][1]
    if case == "none":
        assert runs["port"][1] is None
    _same_tree(runs["jax"][0], runs["port"][0])
    want = jcons.collect_epoch_summaries(runs["jax"][0], exp=exp)
    got = cons.collect_epoch_summaries(runs["port"][0], exp=exp)
    assert got.empty == want.empty
    if not want.empty:
        assert got.index == list(want.index)
        assert got.columns == list(want.columns)
        for col in want.columns:
            for epoch in want.index:
                a, b = got.loc[epoch, col], want.loc[epoch, col]
                assert a == b or (a != a and b != b), (col, epoch)


def _mutated(rng, seq, rate=0.04):
    out = []
    for ch in seq:
        if rng.random() < rate:
            continue
        if rng.random() < rate:
            ch = "ACGT"[rng.integers(4)]
        out.append(ch)
    return "".join(out)


@pytest.mark.parametrize("split", ["val", "test"])
def test_eval_model_on_a_fastq_equals_jax(tmp_path, split):
    """Alignment, demux and analysis of the same FASTQ: the PAF and every
    CSV byte-equal, the summary equal."""
    refs = JXnaRefs("POC")
    rng = np.random.default_rng(1)
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as fh:
        for i, tid in enumerate(refs.targets_id[:8] * 2):
            seq = refs.targets[tid].replace("N", "X" if i % 2 else "Y")
            if i % 2 == 0:
                seq = reverse_complement_str(seq.replace("Y", "X"))
            seq = _mutated(rng, seq)
            write_fastq(fh, f"{tid}_{i}", seq, "5" * len(seq))
    got = eval_model.eval_model("POC", str(tmp_path / "port"), split=split,
                                reads_fastq=str(fq), q_scores=True,
                                save_confusion_matrix=True, **QUIET)
    want = jeval.eval_model("POC", str(tmp_path / "jax"), split=split,
                            reads_fastq=str(fq), q_scores=True,
                            save_confusion_matrix=True, **QUIET)
    assert got["num_aligned_reads"] > 0
    assert list(got) == list(want)
    assert all(got[k] == want[k] or (got[k] != got[k] and want[k] != want[k])
               for k in want)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """Two model dirs of one small architecture (2 layers, 64 features),
    weights_99.npz in JAX's layout from two seeds."""
    cfg = ModelConfig(encoder=EncoderConfig(features=64, num_rnn_layers=2))
    dirs = []
    for seed in (0, 1):
        d = tmp_path_factory.mktemp(f"member{seed}")
        jconfig.save(cfg, str(d))
        jckpt.save_checkpoint(str(d), 99,
                              JaxModel(cfg).init(jax.random.key(seed)))
        dirs.append(str(d))
    return dirs


@pytest.fixture(scope="module")
def lib_reads():
    refs = JXnaRefs("POC")
    return list(sim_library_reads(refs, np.random.default_rng(5), 6, True,
                                  "heldout", read_len_chunks=1))


@pytest.fixture()
def f32(monkeypatch):
    """Both packages decode in f32, where their calls must be identical."""
    monkeypatch.setattr(jbasecall, "basecall", functools.partial(
        jbasecall.basecall, compute_dtype=jnp.float32))
    monkeypatch.setattr(tbasecall, "basecall", functools.partial(
        tbasecall.basecall, compute_dtype=torch.float32))


@pytest.mark.parametrize("n_members", [1, 2])
def test_basecall_and_eval_equals_jax(tmp_path, members, lib_reads, f32,
                                      n_members):
    """One member, or the two as an ensemble (JAX's ``params`` list):
    the FASTQ byte-equal, the summary equal."""
    dirs = members[:n_members]
    arg = dirs if n_members > 1 else dirs[0]
    outs = {}
    for name, fn in (("jax", jeval.basecall_and_eval),
                     ("port", functools.partial(
                         eval_model.basecall_and_eval, device="cpu"))):
        out = str(tmp_path / name)
        outs[name] = (out, fn(arg, lib_reads, "POC", "val", batchsize=4,
                              out_dir=out, **QUIET))
    (jdir, want), (pdir, got) = outs["jax"], outs["port"]
    fq = "reads-POC-val.fastq"
    with open(os.path.join(pdir, fq)) as a, open(os.path.join(jdir, fq)) as b:
        text = a.read()
        assert text == b.read()
    assert text.count("\n") == 4 * len(lib_reads)
    assert got == want
    _same_tree(jdir, pdir)


@pytest.mark.parametrize("n_members", [1, 2])
def test_basecall_and_eval_with_a_beam_equals_jax(tmp_path, members,
                                                  lib_reads, f32, n_members):
    """``beam_width=4`` reaches the basecall in both packages (the beam
    decode, of one model or of the ensemble's mean scores): the FASTQ
    byte-equal, the summary equal, and the calls not all the Viterbi
    decode's FASTQ."""
    dirs = members[:n_members]
    arg = dirs if n_members > 1 else dirs[0]
    outs = {}
    for name, fn in (("jax", jeval.basecall_and_eval),
                     ("port", functools.partial(
                         eval_model.basecall_and_eval, device="cpu")),
                     ("viterbi", None)):
        out = str(tmp_path / name)
        if fn is None:
            outs[name] = (out, eval_model.basecall_and_eval(
                arg, lib_reads, "POC", "val", batchsize=4, out_dir=out,
                device="cpu", **QUIET))
            continue
        outs[name] = (out, fn(arg, lib_reads, "POC", "val", batchsize=4,
                              out_dir=out, beam_width=4, **QUIET))
    (jdir, want), (pdir, got) = outs["jax"], outs["port"]
    fq = "reads-POC-val.fastq"
    texts = {}
    for name, (d, _) in outs.items():
        with open(os.path.join(d, fq)) as fh:
            texts[name] = fh.read()
    assert texts["port"] == texts["jax"]
    assert texts["port"].count("\n") == 4 * len(lib_reads)
    assert texts["port"] != texts["viterbi"]
    assert got == want
    _same_tree(jdir, pdir)


def test_ensemble_of_one_model_twice_equals_the_model(members, lib_reads):
    """(s + s) / 2 == s in f32: the ensemble [m, m] calls what m calls."""
    model, _ = load_model(members[0], device="cpu", weights=99)
    calls = []
    for arg in (model, [model, model]):
        fq = io.StringIO()
        tbasecall.run_basecaller(arg, iter(lib_reads), fq, batchsize=4,
                                 compute_dtype=torch.float32)
        calls.append(fq.getvalue())
    assert calls[0] == calls[1]


def test_train_and_eval_orchestration(tmp_path):
    """Train 2 epochs through the orchestrator, validate each epoch on
    injected FASTQs (epoch 2 calls the UBs, epoch 1 misses them) and pick
    epoch 2 (tests/test_train_and_eval.py, on the port)."""
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.data.ctc_data import save_ctc_data
    from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset
    from xna_basecaller_tpu_torch.eval.xna_refs import XnaRefs

    poc = XnaRefs("POC")
    data_dir = tmp_path / "data"
    save_ctc_data(str(data_dir), *simulate_ctc_dataset(
        12, chunk_len=400, target_len=50, seed=0))
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    config_lib.save(config_lib.ModelConfig(encoder=config_lib.EncoderConfig(
        features=32, num_rnn_layers=2, winlen=9)), str(cfg_dir))
    workdir = str(tmp_path / "run")
    out = train_and_eval(workdir, str(data_dir), exp="POC", epochs=2,
                         batch=4, config=str(cfg_dir), ubs="", device="cpu",
                         **QUIET)
    assert out == {"best_epoch": None, "test_summary": {}, "extra_eval": {}}
    assert os.path.exists(os.path.join(workdir, "weights_2.npz"))

    fq = {}
    for epoch, corrupt in ((1, True), (2, False)):
        p = str(tmp_path / f"fq{epoch}.fastq")
        with open(p, "w") as fh:
            for tid in ["XNA01", "XNA02"]:
                seq = poc.targets[tid].replace("N", "X")
                if corrupt:
                    i = seq.index("X")
                    seq = seq[:i] + "A" + seq[i + 1:]
                write_fastq(fh, f"{tid}_f", seq, "I" * len(seq))
        fq[epoch] = p
    best = run_ub_validation(workdir, "POC", fastq_per_epoch=fq,
                             device="cpu", **QUIET)
    assert best == 2
    assert os.readlink(os.path.join(workdir, "weights_99.npz")) == \
        "weights_2.npz"
    assert os.readlink(os.path.join(workdir, "basecalls")) == \
        "basecalls-weights_2"
    for epoch in (1, 2):
        assert os.path.exists(os.path.join(
            workdir, f"basecalls-weights_{epoch}",
            "results_summ-POC-val.csv"))
