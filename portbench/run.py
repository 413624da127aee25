"""Run one cell of the port's benchmark on the card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  Set-up (kernel build from the port's build
cache, weights and traffic from the seed, warm-up) runs, then the window
of ``--seconds``; with ``--trace 1`` a ``torch.profiler`` trace covers the
window and the per-layer metrics are read from it, else the end-to-end
metrics are reported.  After the window the program's state is freed and
the plain reference judges what the timed path produced.  The last line
of standard output is the result as one JSON object; the numbers compared
and their limits are the last lines of standard error.

Without a CUDA card, or with fewer than the cell asks for, it exits with
code 2 and prints no result.  It exits with code 3, and no result, where
a module of JAX or of the JAX package is loaded.
"""

from time import perf_counter

T_PROCESS = perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from portbench import spec as specs  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "xna_basecaller_tpu")


class Refused(Exception):
    """A run that must end without a result, with its exit code."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def guard(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise Refused(3, f"{when}: forbidden modules loaded: {found}")


def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise Refused(2, "no CUDA device: the benchmark runs on the card "
                         "only")
    if torch.cuda.device_count() < chips:
        raise Refused(2, f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when none is over."""
    checks, ok = {}, True
    for name, lim in limits["checks"].items():
        value = float(numbers[name])
        checks[name] = {"value": value, "limit": lim["limit"]}
        ok = ok and math.isfinite(value) and value <= lim["limit"]
    return ok, checks


def per_layer_metrics(cell: dict, trace, session) -> dict:
    ctx = SimpleNamespace(trace=trace, dims=session.dims,
                          shape=session.shape, traffic=cell["traffic"],
                          config=cell["config"])
    out = {}
    for m in cell["per_layer"]:
        reader = importlib.import_module(f"portbench.readers.{m['reader']}")
        value = reader.read(ctx, m)
        if value is None:
            raise RuntimeError(
                f"{m['name']}: the trace holds nothing for it to read "
                f"(kernel patterns matched no kernel?)")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float = T_PROCESS) -> dict:
    """Set-up, window and check of one cell; returns the result object.
    ``cell`` is ``spec.cell``'s with ``tmpdir`` set.  On the card only,
    but for the tests, which drive it on the CPU at a tiny size."""
    import torch
    on_card = device == "cuda"
    if on_card:
        from xna_basecaller_tpu_torch.ops import _build
        _build.build()
        torch.cuda.reset_peak_memory_stats()
    kind = importlib.import_module(
        f"portbench.kinds.{cell['traffic']['kind']}")
    session = kind.setup(cell, seed, device)
    guard("after set-up")
    tracer = None
    if trace:
        from portbench.trace import Tracer
        tracer = Tracer(cell["tmpdir"])
    win = session.window(seconds, tracer)
    guard("after the window")
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    t_check = perf_counter()
    numbers = session.check()
    win["counters"]["check_s"] = perf_counter() - t_check
    correct, checks = judge(numbers, cell["limits"])
    # the numbers read beside the compared ones, for the record
    win["counters"].update({k: v for k, v in numbers.items()
                            if k not in checks and k != "failed"})
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu", "count": int(cell["entry"]["chips"]),
                   "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": int(win["attempted"]),
              "failed": int(numbers["failed"])}
    if trace:
        tr = tracer.trace
        result["metrics"] = per_layer_metrics(cell, tr, session)
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result["device"] = device_info
        result["breakdown"] = tr.breakdown()
    else:
        produced = dict(win["metrics"])
        produced["setup_s"] = win["t_open"] - t_process
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        result["metrics"] = {n: {"value": produced[n], "unit": u}
                             for n, u in units.items()}
        result["device"] = device_info
    result["counters"] = win["counters"]
    result["checks"] = checks
    guard("at the end")
    return result


def run(args) -> dict:
    cell = specs.cell(args.workload)
    require_cards(int(cell["entry"]["chips"]))
    guard("before set-up")
    cell["tmpdir"] = tempfile.mkdtemp(prefix="portbench-")
    try:
        return run_cell(cell, args.seed, args.seconds, bool(args.trace))
    finally:
        shutil.rmtree(cell["tmpdir"], ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    for m in result["metrics"].values():
        if not math.isfinite(m["value"]):
            print(f"portbench: a metric is not finite: {result['metrics']}",
                  file=sys.stderr)
            return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
