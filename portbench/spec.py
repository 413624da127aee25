"""The benchmark's pieces, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each piece is a file of its own:

* ``portbench/configs/<config>.json``: the model's sections (as its
  ``config.toml`` has them), its source, ``reduced``, ``assumed`` and the
  precision it is served in;
* ``portbench/traffic/<mix>.json``: the kind of work (``basecall`` or
  ``train``, a module ``portbench/kinds/<kind>.py``) and its parameters;
* ``portbench/metrics/<name>.json``: a per-layer metric's reader
  (``portbench/readers/<reader>.py``) and what it reads;
* ``portbench/limits/<cell>.json``: the limit of each number the cell's
  correctness check compares, with the readings it was set from.

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries; no file here names one.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(*parts: str) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return _load(root, "BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in a cell."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: str = ROOT) -> dict:
    """Everything a run of cell ``name`` needs, loaded by name."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = os.path.join(root, "portbench")
    config = _load(here, "configs", entry["config"] + ".json")
    traffic = _load(here, "traffic", entry["traffic"] + ".json")
    per_layer = []
    for m in bench["per_layer"]:
        if applies(m, name):
            spec = _load(here, "metrics", m["name"] + ".json")
            per_layer.append({**spec, **m})
    return {
        "name": name, "entry": entry, "config": config, "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
        "per_layer": per_layer,
        "limits": _load(here, "limits", name + ".json"),
    }
