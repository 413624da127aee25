"""Tiny cells for the CPU tests of the benchmark: the real configurations'
sections at a width of 16 and 2 LSTM layers, chunks of 400 samples in
batches of 8.

Run from the repository root: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import copy
import json
import os

import pytest
import torch

from portbench import spec

torch.set_num_threads(2)


def tiny_config(name: str = "xna_sup_v3.3") -> dict:
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["model"]["encoder"].update(features=16, num_rnn_layers=2)
    cfg["model"]["basecaller"].update(chunksize=400, overlap=50, batchsize=8)
    return cfg


BASECALL = {"kind": "basecall", "pool_reads": 6,
            "length": {"dist": "uniform", "low": 900, "high": 2500},
            "ub_per_read": 1, "samples_per_base": 9.0, "check_reads": 4,
            "check_rows": 16}
TRAIN = {"kind": "train", "chunks": 48, "chunksize": 400, "target_len": 60,
         "samples_per_base": [7.0, 13.0],
         "ub_per_target": 1, "batchsize": 8, "lr": 5e-4,
         "weight_decay": 0.01, "clip": 2.0, "checked_steps": 3}


def make_cell(tmp_path, traffic: dict, limits_of: str,
              config: str = "xna_sup_v3.3") -> dict:
    """A tiny cell held to the limits of the real cell ``limits_of``."""
    with open(os.path.join(spec.HERE, "limits", limits_of + ".json")) as fh:
        limits = json.load(fh)
    bench = spec.benchmark()
    return {"name": "tiny", "entry": {"chips": 1},
            "config": tiny_config(config), "traffic": copy.deepcopy(traffic),
            "end_to_end": [m for m in bench["end_to_end"]
                           if spec.applies(m, limits_of)],
            "per_layer": [], "limits": limits, "tmpdir": str(tmp_path)}


@pytest.fixture
def basecall_cell(tmp_path):
    return make_cell(tmp_path, BASECALL, "xna_sup.basecall")


@pytest.fixture
def train_cell(tmp_path):
    return make_cell(tmp_path, TRAIN, "xna_sup.train")
