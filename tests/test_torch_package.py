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
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.ops import _build, crf_cuda, lstm_cuda
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
             or m == "xna_basecaller_tpu" or m.startswith("xna_basecaller_tpu."))
print(len(names), bad)
"""


def test_imports_no_jax_and_no_jax_package():
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
    assert set(_build.sources()) == {"crf_decode", "lstm_backward",
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


@pytest.mark.parametrize("flag", sorted(NOT_PORTED))
def test_cli_refuses_unported_flags(flag, tmp_path, capsys):
    value = {"--sam": [], "--qscores": [], "--ub-only": [],
             "--quantize": []}.get(flag, ["1"])
    with pytest.raises(SystemExit) as exc:
        port_cli(["basecaller", str(tmp_path), str(tmp_path), flag, *value,
                  "--device", "cpu"])
    assert f"{flag} is not ported" in str(exc.value)


def test_cli_refuses_ensembles_and_other_subcommands(tmp_path):
    with pytest.raises(SystemExit) as exc:
        port_cli(["basecaller", f"{tmp_path},{tmp_path}", str(tmp_path),
                  "--device", "cpu"])
    assert "ensembles" in str(exc.value)
    for cmd in ("duplex", "evaluate"):
        with pytest.raises(SystemExit) as exc:
            port_cli([cmd, "x"])
        assert "not ported" in str(exc.value)
