"""A basecall cell's limits read against the plain reference in fp8, on
the card.

    python3 -m portbench.calibrate_fp8 --workload <cell> --seeds 1,2,...
        [--seconds 4] [--out FILE]

For each seed a sound run of the program (set-up, a window of
``--seconds`` at the cell's own load, the check) and, on the very reads
that run's check drew, the control: the plain reference with every matrix
product of the LSTMs and the head in fp8 (e4m3, one scale a tensor: the
precision below the configuration's bf16, as ``calibrate.py`` takes it
for training) put in the program's place.  Its call of a read keeps, of
each chunk, the frames the stitch keeps, each labelled as the best path
of the fp8 scores labels it there (the Viterbi max-marginal's first
maximum); the judge then reads it against the f32 reference as it reads
the program's.  All seeds run in one process.  Prints one JSON line a seed
(and appends it to ``--out``).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from unittest import mock

import numpy as np
import torch

from portbench import spec as specs
from portbench.kinds import basecall
from portbench.reference import crf
from portbench.reference.chunks import chunk, kept_frames
from portbench.reference.judge import frame_gaps
from portbench.reference.model import forward, fp8_mm, pin_f32
from portbench.run import guard, require_cards
from portbench.weights import make_weights, model_dims


def fp8_calls(weights: dict, model: dict, signals, chunksize: int,
              overlap: int, rows: int, device) -> list:
    """[(signal, moves, sequence)]: each signal called by the reference in
    fp8, ``rows`` chunks at a time."""
    pin_f32()
    dims = model_dims(model)
    nb, sl, alphabet = dims["n_base"], dims["state_len"], dims["alphabet"]
    pieces = [chunk(np.asarray(s, np.float32), chunksize, overlap)
              for s in signals]
    every = np.concatenate(pieces)
    labels = []
    with torch.no_grad():
        for lo in range(0, len(every), rows):
            sig = torch.from_numpy(every[lo:lo + rows]).to(device)
            w = crf.viterbi_weights(forward(weights, model, sig, mm=fp8_mm),
                                    nb, sl)
            labels.append(crf.max_marginals(w, nb).argmax(-1).T.cpu())
            del w
    labels = torch.cat(labels).numpy()                   # [chunks, T]
    calls, at = [], 0
    for s, c in zip(signals, pieces):
        kept = kept_frames(len(c), len(s), chunksize, overlap, dims["stride"])
        lab = np.concatenate([labels[at + i, a:b]
                              for i, (a, b) in enumerate(kept)])
        at += len(c)
        calls.append((s, lab > 0, "".join(alphabet[k] for k in lab[lab > 0])))
    return calls


def shares(gaps: np.ndarray, limits: dict) -> dict:
    return {name: 100.0 * float((gaps > lim["nats"]).mean())
            for name, lim in limits["checks"].items() if "nats" in lim}


def reading(cell: dict, seed: int, seconds: float, device: str) -> dict:
    """The sound run's numbers and the fp8 control's on its checked reads."""
    drawn = {}

    def judge(weights, model, calls, *args):
        drawn["signals"] = [c[0] for c in calls]
        return frame_gaps(weights, model, calls, *args)

    s = basecall.setup(cell, seed, device)
    s.window(seconds)
    with mock.patch.object(basecall, "frame_gaps", judge):
        out = {"workload": cell["name"], "seed": seed,
               "numbers": s.check()}
    model = cell["config"]["model"]
    weights = make_weights(model, seed, device)
    shape = (s.shape["chunksize"], s.shape["overlap"],
             int(cell["traffic"]["check_rows"]), device)
    calls = fp8_calls(weights, model, drawn["signals"], *shape)
    low = frame_gaps(weights, model, calls, *shape)
    out["control_numbers"] = shares(low, cell["limits"])
    out["frames"] = [len(s.gaps), len(low)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = specs.cell(args.workload)
    require_cards(int(cell["entry"]["chips"]))
    from xna_basecaller_tpu_torch.ops import _build
    _build.build()
    for seed in (int(x) for x in args.seeds.split(",") if x):
        cell["tmpdir"] = tempfile.mkdtemp(prefix="portbench-cal-")
        try:
            line = json.dumps(reading(cell, seed, args.seconds, "cuda"))
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
