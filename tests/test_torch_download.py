"""The port's ``xnacall convert`` and ``xnacall download`` against the JAX
package's, on the CPU, as ``tests/test_download.py`` and
``test_cli.py::test_cli_convert_chunkify`` hold JAX's; and every
subcommand's argparser against JAX's.

``convert``: a small chunkify HDF5 file written with h5py from a numpy
seed; the three ``.npy`` files byte-equal to JAX's.  ``download``: the
fetcher on ``file://`` URLs and on a ``http.server`` on 127.0.0.1 (nothing
is fetched from outside the test's directory), skip and ``--force``, the
sha256 check, the CLI against a ``file://`` mirror and without one, and
``--from`` with npz (installed arrays equal JAX's install exactly) and
with a reference ``weights_N.tar`` (rtol 1e-6, as ``test_download.py``
holds JAX's importer).
"""

import hashlib
import http.server
import os
import threading
import zipfile

import numpy as np
import pytest
import torch

from xna_basecaller_tpu.cli import convert as jconvert
from xna_basecaller_tpu.cli import download as jdownload
from xna_basecaller_tpu.cli import main as jax_cli
from xna_basecaller_tpu_torch.cli import convert as tconvert
from xna_basecaller_tpu_torch.cli import download as tdownload
from xna_basecaller_tpu_torch.cli import main as port_cli
from xna_basecaller_tpu_torch.core import config as config_lib
from xna_basecaller_tpu_torch.core.config import EncoderConfig, ModelConfig
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.train import checkpoint as ckpt
from xna_basecaller_tpu_torch.utils.model_io import load_model
from xna_basecaller_tpu_torch.utils.torch_import import export_state_dict
from xna_basecaller_tpu_torch.utils.weights import params_to_jax

CFG = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2))


def _write_chunkify(path, seed=0, n_reads=3, n_samples=2400):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as fh:
        reads = fh.create_group("Reads")
        for i in range(n_reads):
            g = reads.create_group(f"read_{i}")
            n_bases = int(rng.integers(n_samples // 12, n_samples // 6))
            g.create_dataset("Dacs", data=rng.integers(
                0, 2000, size=n_samples).astype(np.int16))
            g.create_dataset("Reference", data=rng.integers(0, 4, n_bases))
            g.create_dataset("Ref_to_signal", data=np.sort(
                rng.integers(0, n_samples, size=n_bases)))
            g.attrs["offset"] = float(rng.uniform(-5, 5))
            g.attrs["range"] = 1400.0
            g.attrs["digitisation"] = 8192.0
            g.attrs["shift_frompA"] = 90.0
            g.attrs["scale_frompA"] = 10.0


NPY = ("chunks.npy", "references.npy", "reference_lengths.npy")


@pytest.mark.parametrize("extra", [["--chunksize", "800"],
                                   ["--chunksize", "600", "--max-reads", "2",
                                    "--seed", "3"]])
def test_convert_matches_jax_cli(tmp_path, capsys, extra):
    h5 = tmp_path / "chunkify.hdf5"
    _write_chunkify(h5, seed=len(extra))
    outs = []
    for who, cli in (("jax", jax_cli), ("port", port_cli)):
        cli(["convert", str(h5), str(tmp_path / who), *extra])
        outs.append(capsys.readouterr().out.replace(str(tmp_path / who),
                                                    ""))
    assert outs[0] == outs[1] and "chunks to" in outs[1]
    for f in NPY:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    assert len(np.load(tmp_path / "port" / "chunks.npy")) > 0


def test_typical_indices_matches_jax():
    x = np.random.default_rng(1).normal(100, 20, 500).astype(np.uint16)
    for n in (1.0, 2.5):
        np.testing.assert_array_equal(tconvert.typical_indices(x, n),
                                      jconvert.typical_indices(x, n))


def _model_dir(path, seed=0):
    os.makedirs(path)
    config_lib.save(CFG, str(path))
    model = Model(CFG, device="cpu", seed=seed)
    ckpt.save_checkpoint(str(path), 3, params_to_jax(model.state_dict()))
    return model


def _make_model_zip(tmp_path, name="zipmodel"):
    src = tmp_path / name
    _model_dir(src, seed=1)
    zpath = tmp_path / f"{name}.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for f in sorted(os.listdir(src)):
            zf.write(src / f, arcname=f"{name}/{f}")
    return zpath


def _same_npz(a, b, rtol=0.0):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            if rtol:
                np.testing.assert_allclose(x[k], y[k], rtol=rtol)
            else:
                np.testing.assert_array_equal(x[k], y[k])


def test_install_npz_model_matches_jax(tmp_path, capsys):
    src = tmp_path / "mymodel"
    _model_dir(src)
    dsts = [mod.install_model(str(src), str(tmp_path / who),
                              log=lambda *a: None)
            for who, mod in (("port", tdownload), ("jax", jdownload))]
    assert os.path.basename(dsts[0]) == "mymodel"
    for f in ("config.toml", "weights_3.npz"):
        assert open(os.path.join(dsts[0], f), "rb").read() == \
            open(os.path.join(dsts[1], f), "rb").read()
    model, _ = load_model(dsts[0], device="cpu")
    assert model.state_dict().keys()
    # the registry listing shows it, as JAX's does
    lists = []
    for cli in (port_cli, jax_cli):
        cli(["download", "--list", "--directory", str(tmp_path / "port")])
        lists.append(capsys.readouterr().out)
    assert lists[0] == lists[1] and "  mymodel" in lists[0]


def _tar_dir(tmp_path, name="refmodel"):
    """A reference-layout model directory: config.toml and a bonito
    ``weights_1.tar`` of a seeded model's weights."""
    src = tmp_path / name
    os.makedirs(src)
    config_lib.save(CFG, str(src))
    model = Model(CFG, device="cpu", seed=4)
    torch.save(export_state_dict(model.state_dict()),
               str(src / "weights_1.tar"))
    return src, model


def test_install_torch_model_matches_jax(tmp_path):
    src, model = _tar_dir(tmp_path)
    logs = {"port": [], "jax": []}
    dsts = [mod.install_model(str(src), str(tmp_path / who),
                              log=logs[who].append)
            for who, mod in (("port", tdownload), ("jax", jdownload))]
    assert logs["port"] == logs["jax"] == [
        "> installed refmodel (1 torch checkpoints converted)"]
    _same_npz(os.path.join(dsts[0], "weights_1.npz"),
              os.path.join(dsts[1], "weights_1.npz"), rtol=1e-6)
    # the installed checkpoint is the model's own weights
    got, _ = load_model(dsts[0], device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)


def test_install_refuses_what_is_not_a_model(tmp_path):
    for d in ("empty", "noweights"):
        (tmp_path / d).mkdir()
    config_lib.save(CFG, str(tmp_path / "noweights"))
    for src, msg in ((tmp_path / "missing", "is not a directory"),
                     (tmp_path / "empty", "has no config.toml"),
                     (tmp_path / "noweights", "no weights_N.npz")):
        for mod in (tdownload, jdownload):
            with pytest.raises(SystemExit, match=msg):
                mod.install_model(str(src), str(tmp_path / "reg"))


def test_file_fetch_zip_extract_skip_force(tmp_path):
    """file:// zip download, extraction, archive removal, skip-if-exists,
    --force re-fetch: the same logs and files as JAX's fetcher."""
    zpath = _make_model_zip(tmp_path)
    logs = {}
    for who, mod in (("port", tdownload), ("jax", jdownload)):
        dest, logs[who] = tmp_path / who, []
        out = mod.File(str(dest), zpath.as_uri(),
                       log=logs[who].append).download()
        assert out == str(dest / "zipmodel")
        assert not os.path.exists(dest / "zipmodel.zip")
        mod.File(str(dest), zpath.as_uri(), log=logs[who].append).download()
        mod.File(str(dest), zpath.as_uri(), force=True,
                 log=logs[who].append).download()
    assert logs["port"] == logs["jax"] == [
        "[downloaded zipmodel.zip]", "[skipping zipmodel.zip]",
        "[downloaded zipmodel.zip]"]
    assert sorted(os.listdir(tmp_path / "port" / "zipmodel")) == \
        sorted(os.listdir(tmp_path / "jax" / "zipmodel"))
    _same_npz(tmp_path / "port" / "zipmodel" / "weights_3.npz",
              tmp_path / "jax" / "zipmodel" / "weights_3.npz")
    model, _ = load_model(str(tmp_path / "port" / "zipmodel"), device="cpu")
    assert model.stride == 5


def test_file_fetch_converts_chunkify_hdf5(tmp_path, capsys):
    """An ``.hdf5`` download is converted to ctc-data by the port's
    ``convert`` into the directory named without ``.hdf5`` (as bonito
    names it): the files JAX's ``convert`` writes from the same file, and
    the next fetch skips it.  JAX's fetcher names the directory as the
    file it has just written, and fails there (a deviation)."""
    _write_chunkify(tmp_path / "sample.hdf5", seed=5, n_samples=12000)
    url = (tmp_path / "sample.hdf5").as_uri()
    logs = []
    out = tdownload.File(str(tmp_path / "port"), url,
                         log=logs.append).download()
    assert out == str(tmp_path / "port" / "sample")
    assert logs == ["[downloaded sample.hdf5]", "[converting sample.hdf5]"]
    jax_cli(["convert", str(tmp_path / "sample.hdf5"), str(tmp_path / "jax")])
    capsys.readouterr()
    for f in NPY:
        assert (tmp_path / "port" / "sample" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    tdownload.File(str(tmp_path / "port"), url, log=logs.append).download()
    assert logs[-1] == "[skipping sample.hdf5]"
    with pytest.raises(FileExistsError):
        jdownload.File(str(tmp_path / "jaxfetch"), url,
                       log=lambda *a: None).download()


def test_file_fetch_sha256(tmp_path):
    zpath = _make_model_zip(tmp_path, "shamodel")
    good = hashlib.sha256(zpath.read_bytes()).hexdigest()
    tdownload.File(str(tmp_path / "m1"), zpath.as_uri(), sha256=good,
                   log=lambda *a: None).download()
    assert os.path.isdir(tmp_path / "m1" / "shamodel")
    for mod in (tdownload, jdownload):
        with pytest.raises(SystemExit, match="sha256 mismatch") as exc:
            mod.File(str(tmp_path / "m2"), zpath.as_uri(), sha256="0" * 64,
                     log=lambda *a: None).download()
        assert not os.path.exists(tmp_path / "m2" / "shamodel.zip")
        assert good in str(exc.value)


def test_file_fetch_http_content_disposition(tmp_path):
    """A fetch from a server on 127.0.0.1 names the file as its
    Content-Disposition says, as JAX's fetcher does."""
    payload = _make_model_zip(tmp_path, "httpmodel").read_bytes()

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Content-Disposition",
                             'attachment; filename="httpmodel.zip"')
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/opaque-fragment"
        for who, mod in (("port", tdownload), ("jax", jdownload)):
            out = mod.File(str(tmp_path / who), url,
                           log=lambda *a: None).download()
            assert out == str(tmp_path / who / "httpmodel")
            assert os.path.exists(os.path.join(out, "config.toml"))
    finally:
        srv.shutdown()
        srv.server_close()


def test_download_cli_with_mirror(tmp_path, monkeypatch, capsys):
    """The CLI against a file:// mirror: the registry's archive lands in
    ``--directory``, with JAX's output, twice (the archive's directory is
    not the registry name that the skip looks for, in JAX's CLI too)."""
    zpath = _make_model_zip(tmp_path, "mirrormodel")
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    (mirror / "xna_r9.4.1_e8_sup@v3.3.zip").write_bytes(zpath.read_bytes())
    monkeypatch.setenv("XNACALL_MODEL_BASE_URL", mirror.as_uri())
    outs = []
    for who, cli in (("port", port_cli), ("jax", jax_cli)):
        for _ in range(2):
            cli(["download", "--models", "--directory", str(tmp_path / who)])
            outs.append(capsys.readouterr().out)
        assert os.path.exists(tmp_path / who / "mirrormodel" / "config.toml")
    assert outs[:2] == outs[2:]
    assert outs[0] == outs[1] == ("[downloading models]\n"
                                  "[downloaded xna_r9.4.1_e8_sup@v3.3.zip]\n")
    with pytest.raises(SystemExit, match="unknown model nope"):
        port_cli(["download", "--model", "nope"])


def test_download_cli_no_mirror_errors(tmp_path, monkeypatch):
    monkeypatch.delenv("XNACALL_MODEL_BASE_URL", raising=False)
    with pytest.raises(SystemExit, match="no model mirror"):
        port_cli(["download", "--models", "--directory", str(tmp_path)])


@pytest.mark.parametrize("layout", ["npz", "tar"])
def test_download_from_installs_as_jax(tmp_path, capsys, layout):
    """``download --from DIR [--model NAME]``: the installed directory's
    files are JAX's install's (npz exact, tar rtol 1e-6)."""
    if layout == "npz":
        src = tmp_path / "src"
        _model_dir(src)
        weights, rtol = "weights_3.npz", 0.0
    else:
        src, _ = _tar_dir(tmp_path, "src")
        weights, rtol = "weights_1.npz", 1e-6
    outs = []
    for who, cli in (("port", port_cli), ("jax", jax_cli)):
        cli(["download", "--from", str(src), "--model", "named",
             "--directory", str(tmp_path / who)])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "> installed named" in outs[0]
    _same_npz(tmp_path / "port" / "named" / weights,
              tmp_path / "jax" / "named" / weights, rtol=rtol)
    assert load_model(str(tmp_path / "port" / "named"), device="cpu")


def _actions(parser) -> list:
    """Each argument, by dest: its flags, nargs, const, default, type (by
    name), choices and whether it is required."""
    out = []
    for a in parser._actions:
        kind = a.type if a.type is None else getattr(a.type, "__name__",
                                                     repr(a.type))
        out.append((a.dest, tuple(a.option_strings), a.nargs, a.const,
                    a.default, kind, a.choices, a.required))
    return sorted(out, key=repr)


@pytest.mark.parametrize("command", ["basecaller", "train", "evaluate",
                                     "view", "convert", "export", "download",
                                     "duplex"])
def test_argparsers_equal_jax(command):
    """Every subcommand takes JAX's arguments; the ones that run a model
    on a device add ``--device`` (``view`` builds its model on ``meta``;
    ``convert`` and ``download`` touch no card)."""
    import importlib

    from xna_basecaller_tpu_torch import cli as tcli

    assert command in tcli.modules
    port = importlib.import_module(f"xna_basecaller_tpu_torch.cli.{command}")
    jax = importlib.import_module(f"xna_basecaller_tpu.cli.{command}")
    got = _actions(port.argparser())
    device = [a for a in got if a[0] == "device"]
    assert len(device) == (command not in ("view", "convert", "download"))
    assert [a for a in got if a[0] != "device"] == _actions(jax.argparser())
