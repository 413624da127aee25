"""The readings that a cell's limits are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--seconds 4] [--out FILE]

For each seed of ``--seeds`` a sound run of the program: set-up, a
window of ``--seconds`` at the cell's own load, the check.  For each of
``--control-seeds`` the control, the precision below the configuration's
bf16.  For basecalling that is the program's own int8 path
(``--quantize``), in place of the sound run.  For training, which has no
such path, it is the plain reference with every matrix product of the
LSTMs and the head in fp8 (e4m3, one scale a tensor) put in the
program's place, judged against the f32 reference on the same batches
and from the same starts as the sound run of that seed (the seeded
weights; the program's state before the window's checked step).  All
seeds run in one process, so the kernels are loaded once.  Prints one
JSON line a run (and appends it to ``--out``).  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import tempfile
from time import perf_counter

import numpy as np
import torch

from portbench import spec as specs
from portbench.faults import FAULTS
from portbench.reference.judge import train_gaps, train_reference
from portbench.reference.model import fp8_mm
from portbench.run import guard, require_cards
from portbench.weights import make_weights


def _numbers(gaps: dict) -> dict:
    return {k: v for k, v in gaps.items() if k != "left_out"}


def reading(cell: dict, seed: int, control: bool, seconds: float,
            device: str) -> dict:
    import importlib
    kind = importlib.import_module(
        f"portbench.kinds.{cell['traffic']['kind']}")
    t0 = perf_counter()
    out = {"workload": cell["name"], "seed": seed, "control": control}
    if cell["traffic"]["kind"] == "train":
        s = kind.setup(cell, seed, device)
        s.window(seconds)
        out["numbers"] = s.check()
        out["left_out"] = s.left_out
        if control:
            t = cell["traffic"]
            model = cell["config"]["model"]
            hyper = (float(t["lr"]), float(t["weight_decay"]),
                     float(t["clip"]), device)
            w = make_weights(model, seed, device)
            low = train_gaps(train_reference(w, model, s.first, *hyper,
                                             mm=fp8_mm), s.ref)
            low_step = train_gaps(train_reference(
                s.before, model, s.batch, *hyper, state=s.start, mm=fp8_mm),
                s.ref_step)
            out["control_numbers"] = {
                **_numbers(low),
                **{f"window_{k}": v for k, v in _numbers(low_step).items()}}
    else:
        s = kind.setup(cell, seed, device, control=control)
        win = s.window(seconds)
        out["window"] = {k: win[k] for k in ("metrics", "counters",
                                             "window_s", "attempted")}
        out["numbers"] = s.check()
        g = s.gaps
        out["stats"] = {
            "frame_top": sorted(g.tolist())[-5:],
            "frame_q": [float(np.quantile(g, q))
                        for q in (0.99, 0.999, 0.9999)],
            "frame_over": [int((g > x).sum())
                           for x in (0.01, 0.1, 0.25, 0.5, 1, 2, 4)],
            "frames": int(len(g))}
    out["seconds"] = perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    p.add_argument("--fault", default=None, choices=sorted(FAULTS),
                   help="plant this fault in the program for every seed "
                        "of --seeds")
    args = p.parse_args(argv)
    cell = specs.cell(args.workload)
    require_cards(int(cell["entry"]["chips"]))
    from xna_basecaller_tpu_torch.ops import _build
    _build.build()
    runs = [(int(x), False) for x in args.seeds.split(",") if x] + \
        [(int(x), True) for x in args.control_seeds.split(",") if x]
    for seed, control in runs:
        cell["tmpdir"] = tempfile.mkdtemp(prefix="portbench-cal-")
        planted = (FAULTS[args.fault]() if args.fault and not control
                   else contextlib.nullcontext())
        try:
            with planted:
                line = reading(cell, seed, control, args.seconds, "cuda")
            line["fault"] = args.fault if not control else None
            line = json.dumps(line)
        finally:
            shutil.rmtree(cell["tmpdir"], ignore_errors=True)
        torch.cuda.empty_cache()
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    guard("at the end")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
