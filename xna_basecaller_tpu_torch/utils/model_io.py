"""Model directory loading: config.toml + weights_{N}.npz.

Port of ``xna_basecaller_tpu/utils/model_io.py::load_model`` for the CRF
model family: the latest checkpoint unless one is named, and command-line
overrides of the basecaller settings.  Model directories written by the
JAX package load as they are.  Reference-format torch checkpoints
(``weights_N.tar``), ``skip_top`` and the CTC family are not ported yet.
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
from xna_basecaller_tpu_torch.utils.weights import params_from_jax


def latest_epoch(dirname: str) -> int | None:
    """Highest N of the weights_N.npz in ``dirname`` (pseudo-epochs such
    as the best-epoch alias 99 included, as inference loading does)."""
    files = glob(os.path.join(dirname, "weights_*.npz"))
    return max((int(re.sub(r".*_([0-9]+)\.npz", r"\1", f)) for f in files),
               default=None)


def load_model(dirname: str, device: str | torch.device = "cuda",
               weights: int | None = None, chunksize: int | None = None,
               batchsize: int | None = None, overlap: int | None = None):
    """Returns (model on ``device``, config) from a model directory."""
    dev = resolve_device(device)
    cfg = config_lib.load(dirname)
    bc = cfg.basecaller
    cfg = replace(cfg, basecaller=replace(
        bc,
        chunksize=chunksize or bc.chunksize,
        overlap=overlap if overlap is not None else bc.overlap,
        batchsize=batchsize or bc.batchsize,
    ))
    if cfg.is_ctc:
        raise NotImplementedError(
            f"{dirname}: the CTC (QuartzNet) model family is not ported yet")
    epoch = weights if weights else latest_epoch(dirname)
    if epoch is None:
        raise FileNotFoundError(
            f"no weights_N.npz in '{dirname}' (reference-format torch "
            "checkpoints are not ported yet)")
    with np.load(os.path.join(dirname, f"weights_{epoch}.npz")) as npz:
        state = params_from_jax({k: npz[k] for k in npz.files})
    model = Model(cfg, device="cpu", seed=None)
    model.load_state_dict(state)
    return model.to(dev), cfg
