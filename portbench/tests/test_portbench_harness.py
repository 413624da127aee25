"""The harness's own parts: every name in BENCHMARK.json resolves to its
files, the window and tail arithmetic, the trace arithmetic and the
readers on a small recorded trace, the result line, the refusal without
a card, and the guard against JAX."""

import importlib
import json
import os
import re
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import run, spec, work
from portbench.kinds.basecall import window_metrics
from portbench.trace import WINDOW, Trace
from portbench.weights import model_dims

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert not any(w.endswith(".py") for w in BENCH["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_resolves(cfg):
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    with open(os.path.join(spec.ROOT, cfg["file"])) as fh:
        data = json.load(fh)
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    cell = spec.cell(name)
    importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    for m in cell["per_layer"]:
        importlib.import_module(f"portbench.readers.{m['reader']}")
        assert any(e["name"] == m["moves"] for e in cell["end_to_end"])
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    assert set(cell["limits"]["checks"])


def test_every_metric_lists_existing_cells():
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(spec.HERE, "metrics",
                                           m["name"] + ".json"))


def test_window_and_tail_arithmetic():
    # reads taken at 0.1 s steps, written 1 s later; window (2, 4]
    pulls = {k: 0.1 * k for k in range(40)}
    finished = [(k, 0.1 * k + 1.0, 1000 + k, 0, None, "")
                for k in range(40)]
    out = window_metrics(finished, pulls, 2.0, 4.0)
    inside = [k for k in range(40) if 2.0 < 0.1 * k + 1.0 <= 4.0]
    assert out["counters"]["reads_in_window"] == len(inside)
    assert out["metrics"]["basecall_samples_per_s"] == pytest.approx(
        sum(1000 + k for k in inside) / 2.0)
    assert out["metrics"]["read_latency_p95_s"] == pytest.approx(1.0)
    slow = [(k, t + (k == inside[-1]) * 5.0, *rest)
            for k, t, *rest in finished]
    p95 = window_metrics(slow, pulls, 2.0, 4.0)["metrics"][
        "read_latency_p95_s"]
    assert p95 == pytest.approx(1.0)   # the slow read left the window


def recorded_trace():
    """A 1 ms window: K1 twice, a product overlapping the first and the
    Viterbi forward (K2b) under the product, a copy running past the
    close; host operations under the gaps."""
    X = "X"
    k1 = "void (anonymous namespace)::lstm_bf16_wg_kernel<false>(bf16*)"
    k2b = "void crf_fwd_viterbi_kernel<4, 6, true, false>(float const*)"
    ev = [{"name": WINDOW, "cat": "user_annotation", "ph": X, "ts": 0,
           "dur": 1000},
          {"name": k1, "cat": "kernel", "ph": X, "ts": 100, "dur": 200},
          {"name": "gemm", "cat": "kernel", "ph": X, "ts": 250, "dur": 150},
          {"name": k2b, "cat": "kernel", "ph": X, "ts": 300, "dur": 50},
          {"name": k1, "cat": "kernel", "ph": X, "ts": 500, "dur": 200},
          {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ph": X, "ts": 900,
           "dur": 200},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ph": X,
           "ts": 0, "dur": 50},
          {"name": "aten::mm", "cat": "cpu_op", "ph": X, "ts": 380,
           "dur": 140},
          {"name": "aten::copy_", "cat": "cpu_op", "ph": X, "ts": 650,
           "dur": 300},
          {"name": "outer", "cat": "cpu_op", "ph": X, "ts": 600,
           "dur": 400}]
    return Trace(ev)


def test_busy_idle_and_breakdown_of_a_recorded_trace():
    tr = recorded_trace()
    assert tr.window_s == pytest.approx(1e-3)
    # [100, 400] + [500, 700] + [900, 1000]
    assert tr.busy_s() == pytest.approx(600e-6)
    bd = tr.breakdown()
    ops = dict(bd["device_ops"])
    assert ops["void (anonymous namespace)::lstm_bf16_wg_kernel<false>"
               "(bf16*)"] == pytest.approx(400e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(100e-6)
    gaps = dict(bd["idle_gaps"])
    # [700, 900] under aten::copy_ (overlap 200, shorter than "outer")
    assert gaps == pytest.approx({"aten::copy_": 200e-6,
                                  "aten::mm": 100e-6,
                                  "cudaLaunchKernel": 100e-6})


def ctx_for(shape):
    with open(os.path.join(spec.HERE, "configs", "xna_sup_v3.3.json")) as fh:
        dims = model_dims(json.load(fh)["model"])
    return SimpleNamespace(trace=recorded_trace(), dims=dims, shape=shape,
                           traffic={}, config={})


def read(metric, shape):
    m = json.load(open(os.path.join(spec.HERE, "metrics", metric + ".json")))
    reader = importlib.import_module(f"portbench.readers.{m['reader']}")
    return reader.read(ctx_for(shape), m)


def test_readers_on_a_recorded_trace():
    # a batch of 8 rows, decoded once in the window
    shape = {"chunksize": 3600, "batchsize": 8}
    assert read("device_idle.basecall", shape) == pytest.approx(40.0)
    dims = ctx_for(shape).dims
    flops = 8 * work.forward_flops(dims, 3600)
    assert read("mfu.basecall", shape) == pytest.approx(
        100 * flops / 1e-3 / work.PEAK_BF16_FLOPS)
    # the batch's 5 K1 calls at all its rows, over K1's 400 us
    assert read("k1_roofline.basecall", shape) == pytest.approx(
        100 * 5 * work.k1_bound_s(720, 8, 768) / 400e-6)
    # nothing of K3 in this trace: no reading, never a 0
    assert read("k3_roofline.train", {"chunksize": 3600,
                                      "batchsize": 64}) is None
    assert read("mfu.train", {"chunksize": 3600, "batchsize": 64}) is None


def test_a_metric_that_reads_nothing_fails_the_run():
    cell = spec.cell("xna_sup.train")
    ctx_trace = recorded_trace()
    with pytest.raises(RuntimeError, match="nothing for it to read"):
        run.per_layer_metrics(cell, ctx_trace, ctx_for(
            {"chunksize": 3600, "batchsize": 64}))


def test_without_a_card_the_run_refuses_and_prints_no_result(
        monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(2 ** 31 + 5),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "no CUDA device" in out.err


@pytest.mark.parametrize("kind", ["basecall", "train"])
def test_the_result_line_of_a_run(kind, basecall_cell, train_cell):
    cell = basecall_cell if kind == "basecall" else train_cell
    result = run.run_cell(cell, 2 ** 31 + 11, 1.0, trace=False,
                          device="cpu")
    line = json.loads(json.dumps(result))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in cell["end_to_end"]}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["checks"]) == set(cell["limits"]["checks"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"] is True and line["failed"] == 0


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "xna_basecaller_tpu_torch_extra",
                        object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    with pytest.raises(run.Refused) as e:
        run.guard("test")
    assert e.value.code == 3
