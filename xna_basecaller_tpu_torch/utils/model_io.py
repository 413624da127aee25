"""Model directory loading: config.toml + weights_{N}.npz.

Port of ``xna_basecaller_tpu/utils/model_io.py::load_model`` for the CRF
model family: the latest checkpoint unless one is named, command-line
overrides of the basecaller settings and of the drop rates, and
``skip_top`` (the CRF head keeps its fresh initialisation, for alphabet
transfer; the checkpoint's head is not even shape-checked).  Model
directories written by either package load as they are.  A directory with
no ``weights_N.npz`` falls back to the reference's torch checkpoints
(``weights_N.tar``, mapped by ``utils/torch_import.py``), the latest one
unless ``weights`` names one, as JAX's ``load_model:55-79`` does; where
``weights`` names an N that has a tar and no npz, the tar loads (JAX
looks for the npz only and raises).  The CTC family is not ported yet.
"""

from __future__ import annotations

import os
import re
from dataclasses import replace
from glob import glob

import numpy as np
import torch

from xna_basecaller_tpu_torch.core import config as config_lib
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.utils.device import resolve_device
from xna_basecaller_tpu_torch.utils.torch_import import load_torch_checkpoint
from xna_basecaller_tpu_torch.utils.weights import params_from_jax


def latest_epoch(dirname: str) -> int | None:
    """Highest N of the weights_N.npz in ``dirname`` (pseudo-epochs such
    as the best-epoch alias 99 included, as inference loading does)."""
    files = glob(os.path.join(dirname, "weights_*.npz"))
    return max((int(re.sub(r".*_([0-9]+)\.npz", r"\1", f)) for f in files),
               default=None)


def load_model(dirname: str, device: str | torch.device = "cuda",
               weights: int | None = None, chunksize: int | None = None,
               batchsize: int | None = None, overlap: int | None = None,
               skip_top: bool = False, drop_rate: float | None = None,
               drop_rate_bottom: float | None = None, seed: int = 0):
    """Returns (model on ``device``, config) from a model directory."""
    dev = resolve_device(device)
    cfg = config_lib.load(dirname)
    bc = cfg.basecaller
    enc = cfg.encoder
    cfg = replace(cfg, basecaller=replace(
        bc,
        chunksize=chunksize or bc.chunksize,
        overlap=overlap if overlap is not None else bc.overlap,
        batchsize=batchsize or bc.batchsize,
    ), encoder=replace(
        enc,
        drop_rate=drop_rate if drop_rate is not None else enc.drop_rate,
        drop_rate_bottom=(drop_rate_bottom if drop_rate_bottom is not None
                          else enc.drop_rate_bottom),
    ))
    if cfg.is_ctc:
        raise NotImplementedError(
            f"{dirname}: the CTC (QuartzNet) model family is not ported yet")
    head = ("head", "head_ext")
    epoch = weights if weights is not None else latest_epoch(dirname)
    npz_path = os.path.join(dirname, f"weights_{epoch}.npz")
    tar_path = None
    if epoch is None:   # no npz: the latest reference-format checkpoint
        tars = glob(os.path.join(dirname, "weights_*.tar"))
        if not tars:
            raise FileNotFoundError(f"no model weights found in '{dirname}'")
        tar_path = max(tars, key=lambda f: int(
            re.sub(r".*_([0-9]+)\.tar$", r"\1", f)))
    elif not os.path.exists(npz_path) and os.path.exists(
            os.path.join(dirname, f"weights_{epoch}.tar")):
        tar_path = os.path.join(dirname, f"weights_{epoch}.tar")
    if tar_path is not None:
        state = {k: v for k, v in load_torch_checkpoint(tar_path, cfg).items()
                 if not (skip_top and k.split(".")[0] in head)}
    else:
        with np.load(npz_path) as npz:
            state = params_from_jax({
                k: npz[k] for k in npz.files
                if not (skip_top and k.split("/")[0] in head)})
    model = Model(cfg, device="cpu", seed=seed if skip_top else None)
    if skip_top:   # the head keeps its fresh initialisation
        state.update({k: v for k, v in model.state_dict().items()
                      if k.split(".")[0] in head})
    model.load_state_dict(state)
    return model.to(dev), cfg

