"""``xnacall download`` — model/training-data fetcher + local installer.

Copied from ``xna_basecaller_tpu/cli/download.py``: the same registry,
default directory (``~/.xna_basecaller_tpu/models``, or
``XNACALL_MODELS_DIR``), mirror variable (``XNACALL_MODEL_BASE_URL``),
fetcher and CLI.  An ``.hdf5`` download goes to this package's
``convert``; ``install_model`` converts a reference ``weights_N.tar``
through this package's ``utils/torch_import.load_torch_checkpoint``,
``utils/weights.params_to_jax`` and ``train/checkpoint.save_checkpoint``
into the ``weights_N.npz`` that both packages load.

Reference surface: ub-bonito/bonito/cli/download.py (the ``File`` box.com
fetcher with skip-if-exists/--force semantics, zip extraction, and
chunkify-HDF5 auto-conversion, plus the model registry).

This build keeps the full fetcher (stdlib urllib — works for http(s)://
and file:// URLs, so it is testable offline and usable on air-gapped
media), adds optional sha256 validation, and keeps ``--from`` as the
local-install path that also converts reference torch checkpoints
(``weights_N.tar``) on the way in.  Registry URLs are configurable via the
XNACALL_MODEL_BASE_URL env var, for mirrors on local media or a local
network.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import sys
import urllib.request
from zipfile import ZipFile

MODELS = {
    "xna_r9.4.1_e8_sup@v3.3": {
        "description": "6-base (NACGTXY) CRF sup model, r9.4.1",
        "file": "xna_r9.4.1_e8_sup@v3.3.zip",
        "sha256": None,  # distributed with the reference release
    },
}

TRAINING = {
    "xna-training-sample": {
        "description": "chunkify HDF5 training sample (auto-converted)",
        "file": "xna-training-sample.hdf5",
        "sha256": None,
    },
}


def default_models_dir() -> str:
    return os.environ.get(
        "XNACALL_MODELS_DIR",
        os.path.expanduser("~/.xna_basecaller_tpu/models"))


def _stem(fname: str) -> str:
    """What a download leaves: a ``.zip``'s extracted directory, an
    ``.hdf5``'s converted ctc-data directory (bonito's name without
    ``.hdf5``), else the file.  JAX's fetcher names the ctc-data directory
    as the ``.hdf5`` file itself, so its conversion fails on the file it
    has just written; the port does not copy that."""
    for ext in (".zip", ".hdf5"):
        if fname.endswith(ext):
            return fname[:-len(ext)]
    return fname


class File:
    """Download one remote file into ``path`` (reference File semantics:
    skip when the extracted artifact already exists, ``force`` re-fetches,
    .zip archives are extracted and removed, chunkify .hdf5 files are
    converted to ctc-data npy)."""

    def __init__(self, path: str, url: str, force: bool = False,
                 sha256: str | None = None, log=print):
        self.path = path
        self.url = url
        self.force = force
        self.sha256 = sha256
        self.log = log

    def location(self, filename: str) -> str:
        return os.path.join(self.path, filename)

    def exists(self, filename: str) -> bool:
        return os.path.exists(self.location(filename))

    def download(self) -> str | None:
        fname = os.path.basename(self.url.rstrip("/"))
        stem = _stem(fname)
        if self.exists(stem) and not self.force:
            self.log(f"[skipping {fname}]")
            return self.location(stem)
        if self.exists(stem) and self.force:
            target = self.location(stem)
            if os.path.isdir(target):
                shutil.rmtree(target)
            else:
                os.remove(target)

        os.makedirs(self.path, exist_ok=True)
        dest = self.location(fname)
        digest = hashlib.sha256()
        with urllib.request.urlopen(self.url) as resp:
            # honour Content-Disposition naming like the reference
            cd = resp.headers.get("content-disposition", "") \
                if hasattr(resp, "headers") else ""
            if 'filename="' in cd:
                fname = cd.split('filename="', 1)[1].split('"', 1)[0]
                stem = _stem(fname)
                dest = self.location(fname)
            total = int(resp.headers.get("content-length", 0) or 0)
            done = 0
            with open(dest, "wb") as fh:
                while True:
                    block = resp.read(1 << 20)
                    if not block:
                        break
                    fh.write(block)
                    digest.update(block)
                    done += len(block)
                    if total:
                        pct = 100.0 * done / total
                        print(f"\r[{fname}: {pct:5.1f}%]", end="",
                              file=sys.stderr)
            if total:
                print(file=sys.stderr)
        if self.sha256 and digest.hexdigest() != self.sha256:
            os.remove(dest)
            raise SystemExit(
                f"{fname}: sha256 mismatch "
                f"(got {digest.hexdigest()}, want {self.sha256})")
        self.log(f"[downloaded {fname}]")

        if fname.endswith(".zip"):
            with ZipFile(dest) as zfile:
                zfile.extractall(self.path)
            os.remove(dest)
            return self.location(stem)
        if fname.endswith(".hdf5"):
            # chunkify training data -> ctc-data npy (reference
            # download.py:68-75 runs cli/convert on it)
            self.log(f"[converting {fname}]")
            from xna_basecaller_tpu_torch.cli import convert
            out = self.location(stem)
            convert.main(convert.argparser().parse_args([dest, out]))
            return out
        return dest


def install_model(src: str, directory: str, name: str | None = None,
                  log=print) -> str:
    """Copy/convert a model directory into the registry.

    Accepts either this framework's layout (config.toml + weights_N.npz)
    or the reference's (config.toml + weights_N.tar, converted via the
    torch importer). Returns the installed path.
    """
    from glob import glob

    if not os.path.isdir(src):
        raise SystemExit(f"{src} is not a directory")
    if not os.path.exists(os.path.join(src, "config.toml")):
        raise SystemExit(f"{src} has no config.toml")
    name = name or os.path.basename(os.path.normpath(src))
    dst = os.path.join(directory, name)
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(src, "config.toml"), dst)

    npz = sorted(glob(os.path.join(src, "weights_*.npz")))
    tars = sorted(glob(os.path.join(src, "weights_*.tar")))
    if npz:
        for f in npz:
            shutil.copy(f, dst)
        log(f"> installed {name} ({len(npz)} checkpoints)")
    elif tars:
        from xna_basecaller_tpu_torch.core import config as config_lib
        from xna_basecaller_tpu_torch.train.checkpoint import save_checkpoint
        from xna_basecaller_tpu_torch.utils.torch_import import (
            load_torch_checkpoint,
        )
        from xna_basecaller_tpu_torch.utils.weights import params_to_jax

        cfg = config_lib.load(src)
        n = 0
        for f in tars:
            epoch = int(os.path.basename(f)[8:-4])
            state = load_torch_checkpoint(f, cfg)
            save_checkpoint(dst, epoch, params_to_jax(state))
            n += 1
        log(f"> installed {name} ({n} torch checkpoints converted)")
    else:
        raise SystemExit(f"{src} has no weights_N.npz or weights_N.tar")
    return dst


def _base_url() -> str | None:
    return os.environ.get("XNACALL_MODEL_BASE_URL")


def main(args):
    if args.source:
        install_model(args.source, args.directory, name=args.model or None)
        return
    if args.show or not (args.models or args.training or args.all
                         or args.model):
        print("available models:")
        for name, info in MODELS.items():
            print(f"  {name}: {info['description']}")
        print("available training data:")
        for name, info in TRAINING.items():
            print(f"  {name}: {info['description']}")
        print("\ninstalled models:")
        if os.path.isdir(args.directory):
            for name in sorted(os.listdir(args.directory)):
                if os.path.exists(
                        os.path.join(args.directory, name, "config.toml")):
                    print(f"  {name}")
        return

    base = _base_url()
    if base is None:
        raise SystemExit(
            "no model mirror configured: set "
            "XNACALL_MODEL_BASE_URL to an http(s):// or file:// mirror, "
            "or install from local media with: xnacall download "
            "--from <dir> [--model NAME]")

    def fetch(registry, path):
        for name, info in registry.items():
            if args.model and name != args.model:
                continue
            File(path, f"{base.rstrip('/')}/{info['file']}",
                 force=args.force, sha256=info.get("sha256")).download()

    if args.model and args.model not in MODELS and \
            args.model not in TRAINING:
        raise SystemExit(f"unknown model {args.model}")
    if args.models or args.all or args.model in MODELS:
        print("[downloading models]")
        fetch(MODELS, args.directory)
    if args.training or args.all or args.model in TRAINING:
        print("[downloading training data]")
        fetch(TRAINING, args.data_directory)


def argparser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--all", action="store_true")
    group.add_argument("--models", action="store_true")
    group.add_argument("--training", action="store_true")
    parser.add_argument("--model", default="")
    parser.add_argument("--list", "--show", dest="show",
                        action="store_true")
    parser.add_argument("-f", "--force", action="store_true")
    parser.add_argument("--from", dest="source", default=None,
                        help="install a model from a local directory "
                             "(framework npz or reference torch layout)")
    parser.add_argument("--directory", default=default_models_dir())
    parser.add_argument("--data-directory", default=os.path.expanduser(
        "~/.xna_basecaller_tpu/data"))
    return parser
