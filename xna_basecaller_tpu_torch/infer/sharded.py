"""Data-parallel basecalling over several devices of one process.

Port of ``xna_basecaller_tpu/infer/sharded.py:1-58``.  JAX replicates the
parameters over its mesh and shards the chunk batch on axis 0; here the
model is copied onto each device the caller lists (the model carries its
weights, so there is no ``params`` argument), the batch is padded to a
multiple of the device count (``parallel/mesh.py::pad_to_multiple``), and
each device runs the forward and the decode of its contiguous slice (the
Viterbi decode K2a/b/c, or with ``qscores`` the q-score variants; their
plain versions on the CPU).  Per-chunk decoding needs no collective.  All
slices are enqueued before any is fetched, so the devices run together.
The devices come from the caller: there is no single-device default.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from xna_basecaller_tpu_torch.infer.basecall import (
    _score_and_decode, _score_and_decode_qual,
)
from xna_basecaller_tpu_torch.parallel.mesh import pad_to_multiple
from xna_basecaller_tpu_torch.utils.device import on_device, resolve_device


def make_sharded_scorer(model, devices, reverse: bool = False,
                        qscores: bool = False,
                        compute_dtype=torch.bfloat16):
    """Returns scorer(batch [N, T] float) -> paths [N, T'] int8 (with
    ``qscores``: (paths, probs f16)).  The model reads the batch in f16,
    as JAX's scorer casts it."""
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("make_sharded_scorer needs at least one device")
    home = next(model.parameters()).device
    replicas = {}
    for d in devices:
        if d not in replicas:
            replicas[d] = model if d == home else copy.deepcopy(model).to(d)
    n_base = model.seqdist.n_base
    state_len = model.seqdist.state_len

    def scorer(batch):
        padded, n = pad_to_multiple(torch.as_tensor(np.asarray(batch)),
                                    len(devices))
        rows = len(padded) // len(devices)
        outs = []
        with torch.inference_mode():
            for i, d in enumerate(devices):
                # each slice's kernels launch on its own card
                with on_device(d):
                    # cast to f16 on the device: the values of JAX's host
                    # cast (both round to nearest even), without numpy's
                    # slow one
                    x = padded[i * rows:(i + 1) * rows].to(d).to(
                        torch.float16)
                    scores = replicas[d](x, compute_dtype)
                    if qscores:
                        outs.append(_score_and_decode_qual(
                            scores, n_base, state_len, reverse))
                    else:
                        outs.append((_score_and_decode(
                            scores, n_base, state_len, reverse),))
                    del scores
            paths = torch.cat([o[0].cpu() for o in outs]).numpy()[:n]
            if qscores:
                probs = torch.cat([o[1].cpu() for o in outs]).numpy()[:n]
                return paths, probs
        return paths

    return scorer


def sharded_compute_scores(model, batch, devices, reverse: bool = False,
                           compute_dtype=torch.bfloat16) -> dict:
    """One-shot sharded scoring: {"path": [N, T'] int8}."""
    scorer = make_sharded_scorer(model, devices, reverse=reverse,
                                 compute_dtype=compute_dtype)
    return {"path": scorer(batch)}
