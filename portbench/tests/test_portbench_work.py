"""The operation and byte counts against the hand sums of the port's
kernel table and of the benchmark's definition."""

import json
import os

import pytest

from portbench import spec, work
from portbench.weights import model_dims


def dims(name):
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as fh:
        return model_dims(json.load(fh)["model"])


@pytest.mark.parametrize("name, gflop", [("xna_sup_v3.3", 35.74),
                                         ("dna_hac_v3.3", 9.23)])
def test_forward_flops_of_a_chunk(name, gflop):
    assert work.forward_flops(dims(name), 3600) / 1e9 == pytest.approx(
        gflop, abs=0.01)   # the hand sums are given to 2 decimals


def test_xna_sup_parts():
    d = dims("xna_sup_v3.3")
    assert work.lstm_flops(d, 3600) / 1e9 == pytest.approx(33.97, abs=0.005)
    assert work.head_flops(d, 3600) / 1e9 == pytest.approx(1.43, abs=0.005)
    assert work.conv_flops(d, 3600) / 1e9 == pytest.approx(0.34, abs=0.005)


@pytest.mark.parametrize("bound, n, ms", [("k1", 256, 0.879),
                                          ("k3a", 64, 0.220),
                                          ("k3b", 64, 0.440)])
def test_recurrence_bounds_at_flagship_width(bound, n, ms):
    assert work.BOUNDS[bound](720, n, 768) * 1e3 == pytest.approx(ms,
                                                                  abs=0.0005)


def test_k1_is_bound_by_operations_and_k1_at_half_width():
    ops = work.recurrence_ops(720, 256, 768) / work.PEAK_BF16_FLOPS
    assert work.k1_bound_s(720, 256, 768) == ops
    # H=384: 217 GFLOP, 0.22 ms; its 707 MB take 0.211 ms
    assert work.k1_bound_s(720, 256, 384) * 1e3 == pytest.approx(0.2199,
                                                                 abs=1e-4)
