"""The port stands alone: it imports no JAX and nothing of the JAX
package, its entry points run on the card unless asked for the CPU, and
its CLI refuses every option it does not port yet."""

import os
import subprocess
import sys

import pytest
import torch

from xna_basecaller_tpu_torch.cli import main as port_cli
from xna_basecaller_tpu_torch.cli.basecaller import NOT_PORTED
from xna_basecaller_tpu_torch.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu_torch.data.ctc_data import save_ctc_data
from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset
from xna_basecaller_tpu_torch.infer.sharded import make_sharded_scorer
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.ops import _build, crf_cuda, lstm_cuda
from xna_basecaller_tpu_torch.parallel.mesh import make_mesh
from xna_basecaller_tpu_torch.train.loop import Trainer
from xna_basecaller_tpu_torch.utils.model_io import load_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import xna_basecaller_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "xna_basecaller_tpu" or m.startswith("xna_basecaller_tpu.")
             or m.split(".")[0] in ("pandas", "sklearn"))
print(len(names), bad)
"""


def test_imports_no_jax_and_no_jax_package():
    """Nor pandas or sklearn, which the card's machine does not have."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20
    assert bad.strip() == "[]"


def test_no_jax_import_lines():
    for dirpath, _, files in os.walk(os.path.join(ROOT,
                                                  "xna_basecaller_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                for line in fh:
                    words = line.split()
                    if words[:1] in (["import"], ["from"]) and len(words) > 1:
                        mod = words[1].split(".")[0].rstrip(",")
                        assert mod not in ("jax", "jaxlib",
                                           "xna_basecaller_tpu"), (f, line)


def test_nothing_built_at_import():
    # importing every module builds no kernel (nvcc runs at first use)
    assert _build.build_log() == ""
    assert set(_build.sources()) == {"crf_beam", "crf_decode", "crf_loss",
                                     "lstm_backward", "lstm_int8",
                                     "lstm_recurrence"}


def test_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cfg = ModelConfig(encoder=EncoderConfig(features=16, num_rnn_layers=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli(["basecaller", str(tmp_path), str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Model(cfg), [], [])
    save_ctc_data(str(tmp_path / "data"),
                  *simulate_ctc_dataset(4, chunk_len=300, target_len=20))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli(["train", str(tmp_path / "run"), "--directory",
                  str(tmp_path / "data")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_sharded_scorer(Model(cfg, device="cpu"), ["cuda:0"])
    assert next(Model(cfg, device="cpu").parameters()).device.type == "cpu"


def test_wrappers_refuse_tensors_they_cannot_take():
    meta = torch.empty(4, 2, 64, device="meta")
    with pytest.raises(ValueError):
        lstm_cuda.lstm_recurrence(meta, torch.empty(16, 64, device="meta"))
    with pytest.raises(ValueError):
        crf_cuda.backward_scan(torch.empty(3, 2, 80, device="meta"), 4, 2)
    w = torch.empty(16, 64, device="meta")
    with pytest.raises(ValueError):
        lstm_cuda.lstm_forward_with_cells(meta, w)
    ys = torch.empty(4, 2, 16, device="meta")
    with pytest.raises(ValueError):
        lstm_cuda.lstm_backward_dxp(ys, meta, w, ys, ys)
    scores = torch.empty(3, 2, 80, device="meta")
    with pytest.raises(ValueError):
        crf_cuda.forward_scan(scores, 4, 2)
    alphas, n2 = torch.empty(4, 2, 16, device="meta"), torch.empty(2)
    with pytest.raises(ValueError):
        crf_cuda.edge_posteriors(scores, alphas, alphas, n2)
    stay, move = meta[..., :5], meta[..., :4]
    with pytest.raises(ValueError):
        crf_cuda.lattice_forward(stay, move, n2)
    with pytest.raises(ValueError):
        crf_cuda.lattice_backward(stay, move, n2, stay, n2, n2)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_recurrence_int8(
            meta, torch.empty(16, 64, dtype=torch.int8, device="meta"),
            torch.empty(64, device="meta"))


@pytest.mark.parametrize("flag", sorted(NOT_PORTED))
def test_cli_refuses_unported_flags(flag, tmp_path, capsys):
    # a value that changes JAX's result: not its default
    value = {"--superbatch": ["2"]}.get(flag, ["1"])
    with pytest.raises(SystemExit) as exc:
        port_cli(["basecaller", str(tmp_path), str(tmp_path), flag, *value,
                  "--device", "cpu"])
    assert f"{flag} is not ported" in str(exc.value)


@pytest.mark.parametrize("args", [
    # JAX's defaults
    ["--beamsize", "5", "--beam", "0", "--superbatch", "1",
     "--ctc-min-coverage", "0.9", "--ctc-min-accuracy", "0.95"],
    # JAX passes --beamsize to the CTC family only; the filters act only
    # with --save-ctc
    ["--beamsize", "1", "--ctc-min-coverage", "0.5", "--ctc-min-accuracy",
     "0.1"],
    # with --qscores or --beam JAX runs --superbatch G as 1 (a warning)
    ["--qscores", "--superbatch", "2"],
    ["--beam", "3", "--superbatch", "4"],
    # ported since: superbatches, BAM (with a reference) and CRAM
    ["--superbatch", "4"],
    ["--cram", "out.cram"],
    ["--reference", "ref.fasta", "--bam", "out.bam"],
])
def test_cli_accepts_what_changes_no_result(args, tmp_path):
    """Values with which JAX computes what the port does pass the flag
    check: the command goes on to load the model, and finds none."""
    with pytest.raises(FileNotFoundError):
        port_cli(["basecaller", str(tmp_path), str(tmp_path), *args,
                  "--device", "cpu"])


def _model_dir(path, features=16, layers=1, seed=0):
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.train import checkpoint as ckpt
    from xna_basecaller_tpu_torch.utils.weights import params_to_jax

    cfg = ModelConfig(encoder=EncoderConfig(features=features,
                                            num_rnn_layers=layers))
    os.makedirs(path)
    config_lib.save(cfg, str(path))
    ckpt.save_checkpoint(str(path), 1, params_to_jax(
        Model(cfg, device="cpu", seed=seed).state_dict()))
    return str(path)


def test_cli_refuses_ensembles_and_other_subcommands(tmp_path):
    """Ensemble members of another architecture are refused, as JAX
    refuses them; the subcommands not ported yet are refused."""
    a = _model_dir(tmp_path / "a")
    for name, kw in (("wider", dict(features=32)), ("deeper",
                                                     dict(layers=2))):
        b = _model_dir(tmp_path / name, **kw)
        with pytest.raises(SystemExit) as exc:
            port_cli(["basecaller", f"{a},{b}", str(tmp_path),
                      "--device", "cpu"])
        assert "architecturally incompatible" in str(exc.value)
    for cmd in ("duplex", "evaluate"):
        with pytest.raises(SystemExit) as exc:
            port_cli([cmd, "x"])
        assert "not ported" in str(exc.value)


def test_cli_basecalls_an_ensemble(tmp_path, capsys, monkeypatch):
    """``basecaller d1,d2`` loads both members and calls every read
    through the mean of their scores (``infer.basecall._forward``)."""
    from xna_basecaller_tpu_torch.data import fast5
    from xna_basecaller_tpu_torch.data.simulate import simulate_reads
    from xna_basecaller_tpu_torch.infer import basecall

    reads = list(simulate_reads(2, mean_len=3000, seed=1))
    monkeypatch.setattr(fast5, "get_reads", lambda *a, **kw: iter(reads))
    seen = []
    forward = basecall._forward
    monkeypatch.setattr(basecall, "_forward", lambda models, *a: (
        seen.append(len(models)), forward(models, *a))[1])
    dirs = [_model_dir(tmp_path / f"m{i}", seed=i) for i in (0, 1)]
    port_cli(["basecaller", ",".join(dirs), str(tmp_path), "--device",
              "cpu", "--chunksize", "1200", "--overlap", "200",
              "--batchsize", "4"])
    out = capsys.readouterr().out
    assert [ln[1:] for ln in out.splitlines()[::4]] == \
        [r.read_id for r in reads]
    assert seen and set(seen) == {2}
