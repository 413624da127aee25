"""The port's north-star script (``tools/spliced_northstar.py``) against
``scripts/spliced_northstar.py`` on the CPU.

- Phase B from a bootstrap model carried across in JAX's checkpoint layout
  (random weights, f32 decode in both): both chains call the same
  chunk-reads, align none of them, log the same filter counts and stop
  with the same error.
- Phase B with an oracle basecaller in both packages (each chunk-read
  called as the slice of its simulated read's sequence that its samples
  cover, so that chunks pass the chain's gates): two shards, merged, with
  DTW breakpoints; every ctc-data file byte-equal.
- The SWA and soup checkpoints: the same arrays.
- ``main`` at micro size (1 LSTM layer of 16, two seeds, the oracle
  basecaller): every phase runs, the summary has JAX's keys.
"""

import argparse
import filecmp
import functools
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu.data import simulate as jsimulate
from xna_basecaller_tpu.infer import basecall as jbasecall
from xna_basecaller_tpu.models.crf_model import Model as JaxModel
from xna_basecaller_tpu.train import checkpoint as jckpt
from xna_basecaller_tpu_torch.data import simulate as tsimulate
from xna_basecaller_tpu_torch.infer import basecall as tbasecall
from xna_basecaller_tpu_torch.tools import spliced_northstar as ns
from xna_basecaller_tpu_torch.train import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "scripts", "spliced_northstar.py")


@pytest.fixture(scope="module")
def jns():
    spec = importlib.util.spec_from_file_location("jax_spliced_northstar",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def boot_dir(tmp_path_factory):
    cfg = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2))
    d = tmp_path_factory.mktemp("boot")
    jconfig.save(cfg, str(d))
    jckpt.save_checkpoint(str(d), 1, JaxModel(cfg).init(jax.random.key(3)))
    return str(d)


def _args(out, **kw):
    a = dict(exp="CPLX", out=str(out), xna_reads=4, dna_reads=4,
             read_chunks=2, shard_reads=12000, ctc_min_acc=0.85,
             dna_min_acc=None, jitter=False, batch=4, n_proc=0,
             device="cpu")
    a.update(kw)
    return argparse.Namespace(**a)


def _logs(monkeypatch, module):
    lines = []
    monkeypatch.setattr(module, "log", lambda *a: lines.append(
        " ".join(str(x) for x in a)))
    return lines


def _untimed(lines):
    return [re.sub(r"\(\d+s\)|in \d+s", "", ln) for ln in lines]


def test_phase_b_from_carried_over_weights_equals_jax(tmp_path, jns,
                                                      boot_dir, monkeypatch):
    monkeypatch.setattr(jbasecall, "basecall", functools.partial(
        jbasecall.basecall, compute_dtype=jnp.float32))
    monkeypatch.setattr(tbasecall, "basecall", functools.partial(
        tbasecall.basecall, compute_dtype=torch.float32))
    jlog, tlog = _logs(monkeypatch, jns), _logs(monkeypatch, ns)
    errors = []
    for mod, out in ((jns, tmp_path / "jax"), (ns, tmp_path / "port")):
        with pytest.raises(RuntimeError) as exc:
            mod.phase_b_bootstrap_data(_args(out), boot_dir)
        errors.append(str(exc.value))
    assert errors[0] == errors[1] == "bootstrap produced no xna ctc data"
    assert _untimed(tlog) == _untimed(jlog)
    assert any("0/8 chunks kept" in ln for ln in tlog)


class Oracle:
    """A basecaller for both packages that calls each read as the part of
    its simulated sequence that its samples cover: a whole simulated read
    (it carries its sequence) as that sequence; chunk j of 3600 samples of
    a read (id ``<read>:<j>``, as phase B cuts them) as the proportional
    slice of the read's sequence.  The simulators are wrapped to note each
    read's sequence and length."""

    def __init__(self, monkeypatch):
        self.seqs = {}
        for mod in (jsimulate, tsimulate):
            monkeypatch.setattr(mod, "sim_library_reads", functools.partial(
                self._noting, mod.sim_library_reads))
        monkeypatch.setattr(jbasecall, "basecall", (
            lambda model, params, reads, *a, **kw: self.basecall(reads)))
        monkeypatch.setattr(tbasecall, "basecall", (
            lambda model, reads, *a, **kw: self.basecall(reads)))

    def _noting(self, sim, *a, **kw):
        for read in sim(*a, **kw):
            self.seqs[read.read_id] = (read.sequence, len(read.signal))
            yield read

    def call(self, read) -> str:
        if getattr(read, "sequence", ""):
            return read.sequence
        rid, j = read.read_id.rsplit(":", 1)
        seq, n = self.seqs[rid]
        j = int(j)
        return seq[len(seq) * j * 3600 // n:len(seq) * (j + 1) * 3600 // n]

    def basecall(self, reads):
        for read in reads:
            seq = self.call(read)
            yield read, {"sequence": seq, "qstring": "O" * len(seq)}


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert sorted(os.listdir(b)) == names
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n


def test_phase_b_ctc_data_equals_jax(tmp_path, jns, boot_dir, monkeypatch):
    Oracle(monkeypatch)
    _logs(monkeypatch, jns), _logs(monkeypatch, ns)
    dirs = {}
    for name, mod in (("jax", jns), ("port", ns)):
        out = tmp_path / name
        dirs[name] = mod.phase_b_bootstrap_data(
            _args(out, xna_reads=6, dna_reads=6, shard_reads=3), boot_dir)
    for kind in (0, 1):
        jdir, pdir = dirs["jax"][kind], dirs["port"][kind]
        assert os.path.basename(jdir) == os.path.basename(pdir)
        assert len(np.load(os.path.join(pdir, "chunks.npy"))) > 0
        assert os.path.exists(os.path.join(pdir, "breakpoints.npy"))
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_swa_and_soup_checkpoints_equal_jax(tmp_path, jns):
    cfg = ModelConfig(encoder=EncoderConfig(features=16, num_rnn_layers=2))
    for name in ("jax", "port"):
        for i in (0, 1):
            d = tmp_path / name / f"m{i}"
            d.mkdir(parents=True)
            jconfig.save(cfg, str(d))
            for e in (1, 2, 3, 4, 99):
                jckpt.save_checkpoint(str(d), e, JaxModel(cfg).init(
                    jax.random.key(10 * i + e)))
    for name, mod in (("jax", jns), ("port", ns)):
        members = [str(tmp_path / name / f"m{i}") for i in (0, 1)]
        mod._write_swa_checkpoint(argparse.Namespace(epochs=4), members[0])
        mod._write_soup_dir(str(tmp_path / name / "soup"), members)
    for rel in ("m0/weights_90.npz", "soup/weights_99.npz"):
        got = ckpt.load_flat(str(tmp_path / "port" / rel))
        want = ckpt.load_flat(str(tmp_path / "jax" / rel))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for rel in ("m0/weights_90.reserved", "soup/weights_99.reserved",
                "soup/config.toml"):
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "jax" / rel,
                           shallow=False)


# the keys of scripts/spliced_northstar.py's northstar_summary.json
SUMMARY_KEYS = ["exp", "best_epoch", "best_seed", "winner_dir",
                "val_err_only_ub", "seed_candidates",
                "ensemble_val_err_only_ub", "soup_val_err_only_ub",
                "wall_seconds", "test_heldout", "test_oracle",
                "test_in_distribution", "test-ind_oracle", "POC-test",
                "POC-test_oracle"]


def test_main_at_micro_size_writes_jax_summary_keys(tmp_path, monkeypatch):
    with open(JAX_SCRIPT) as fh:
        script = fh.read()
    for key in SUMMARY_KEYS[:9] + ["test_heldout", "test_in_distribution"]:
        assert f'"{key}"' in script, key
    Oracle(monkeypatch)
    lines = _logs(monkeypatch, ns)
    out = tmp_path / "ns"
    summary = ns.main([
        "--out", str(out), "--cpu", "--features", "16", "--layers", "1",
        "--batch", "8", "--boot-chunks", "40", "--boot-epochs", "1",
        "--xna-reads", "6", "--dna-reads", "6", "--epochs", "2",
        "--seeds", "25,26", "--val-reads", "6", "--test-reads", "4",
        "--n-proc", "0"])
    assert list(summary) == SUMMARY_KEYS
    with open(out / "northstar_summary.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(summary))
    assert [c["seed"] for c in sorted(summary["seed_candidates"],
                                      key=lambda c: c["seed"])] == [25, 26]
    for phase in "ABCDE":
        assert any(ln.startswith(f"> [{phase}]") and "wall time" in ln
                   for ln in lines), phase
    for seed in (25, 26):
        d = out / f"spliced_model_s{seed}"
        assert (d / "weights_2.npz").exists()
        assert (d / "basecalls-weights_2"
                / "results_summ-CPLX-val.csv").exists()
    assert summary["test_heldout"]["num_aligned_reads"] > 0
