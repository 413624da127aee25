"""Data-parallel training on the cards of one machine: the ``train`` CLI
under ``torch.distributed.run --nproc-per-node N`` against one process.

    python -m xna_basecaller_tpu_torch.tools.dp_scaling --nproc 4
        [--steps 8] [--batch 64] [--workdir DIR] [--device cpu]
        [--config TOML] [--chunk-len 3600] [--target-len 400]

Writes seeded simulated ctc-data (``data/simulate.py``), then trains one
epoch of ``--steps`` steps three times, each run a command of its own:

1. one process, global batch B;
2. N processes, global batch B (B/N rows a rank), the same steps as 1:
   its losses, grad norms, validation and weights are held to run 1's.
   The tolerances cover a bf16 forward over another row count and the
   card's training step, which is not bit-repeatable from run to run
   (``torch.gather``'s backward adds with atomics): losses and the
   validation loss rtol 1e-3, grad norms rtol 1e-2, weights within 2 x
   the learning rates' sum (AdamW moves an element by about lr whatever
   its gradient's size);
3. N processes, global batch N x B (B rows a rank): weak scaling, the
   samples/s of N cards against run 1's one.

Prints each run's step times (host clock at each step's enqueue, from
``losses_1.csv``; the median over steps 3..) and samples/s, then one JSON
line.  Exits non-zero if a run fails or run 2 leaves the tolerances.
Without ``--config`` the flagship ``ModelConfig()`` is trained.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
VALID_SPLIT = 0.97   # data/ctc_data.py::load_datasets' default


def chunks_for(steps: int, batch: int) -> int:
    """The fewest chunks whose training split holds ``steps`` batches."""
    n = steps * batch
    while int(np.floor(n * VALID_SPLIT)) < steps * batch:
        n += 1
    return n


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train(workdir: str, data: str, nproc: int, batch: int, chunks: int,
          args) -> list[dict]:
    """One ``train`` run; returns its losses_1.csv rows."""
    launcher = ([] if nproc == 1 else [
        "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
        "--master-port", str(_free_port())])
    argv = [sys.executable, *launcher, "-m", "xna_basecaller_tpu_torch",
            "train", workdir, "--directory", data, "--chunks", str(chunks),
            "--epochs", "1", "--batch", str(batch), "--seed", "0",
            "--device", args.device, "-f"]
    if args.config:
        argv += ["--config", args.config]
    p = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": ROOT})
    if p.returncode:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
        raise SystemExit(f"dp_scaling: the run in {workdir} failed")
    with open(os.path.join(workdir, "losses_1.csv")) as fh:
        return list(csv.DictReader(fh))


def step_ms(rows: list[dict]) -> float:
    times = np.diff([0.0] + [float(r["time"]) for r in rows]) * 1e3
    return statistics.median(times[2:] if len(times) > 2 else times)


def compare(one: str, two: str, rows1, rows2) -> dict:
    """Run 2 against run 1 (see the module's docstring)."""
    from xna_basecaller_tpu_torch.train.checkpoint import load_flat

    rel = {k: max(abs(float(a[k]) - float(b[k])) / abs(float(a[k]))
                  for a, b in zip(rows1, rows2))
           for k in ("loss", "grad_norm")}
    with open(os.path.join(one, "training.csv")) as fh:
        v1 = float(list(csv.DictReader(fh))[-1]["validation_loss"])
    with open(os.path.join(two, "training.csv")) as fh:
        v2 = float(list(csv.DictReader(fh))[-1]["validation_loss"])
    w1 = load_flat(os.path.join(one, "weights_1.npz"))
    w2 = load_flat(os.path.join(two, "weights_1.npz"))
    out = {"steps": [len(rows1), len(rows2)], "loss_rel": rel["loss"],
           "grad_norm_rel": rel["grad_norm"],
           "validation_rel": abs(v1 - v2) / abs(v1),
           "weights_abs": max(float(np.abs(w1[k] - w2[k]).max())
                              for k in w1),
           "weights_tol": 2 * sum(float(r["lr"]) for r in rows1)}
    out["ok"] = (len(rows1) == len(rows2) and out["loss_rel"] <= 1e-3
                 and out["grad_norm_rel"] <= 1e-2
                 and out["validation_rel"] <= 1e-3
                 and out["weights_abs"] <= out["weights_tol"])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nproc", type=int, required=True)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--workdir", default=os.path.join(
        ROOT, "runs", "dp_scaling"))
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--chunk-len", type=int, default=3600)
    parser.add_argument("--target-len", type=int, default=400)
    args = parser.parse_args(argv)
    from xna_basecaller_tpu_torch.data.ctc_data import save_ctc_data
    from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset

    card = "cpu"
    if args.device == "cuda":
        import torch

        from xna_basecaller_tpu_torch.ops import _build

        if torch.cuda.device_count() < args.nproc:
            raise SystemExit(f"dp_scaling: {args.nproc} cards asked for, "
                             f"{torch.cuda.device_count()} present")
        _build.build()   # once, before the ranks load the libraries
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    shutil.rmtree(args.workdir, ignore_errors=True)
    data = os.path.join(args.workdir, "data")
    n_one, n_weak = (chunks_for(args.steps, args.batch),
                     chunks_for(args.steps, args.batch * args.nproc))
    save_ctc_data(data, *simulate_ctc_dataset(
        n_weak, chunk_len=args.chunk_len, target_len=args.target_len,
        seed=0))
    runs = {"1 process, batch B": (1, args.batch, n_one),
            f"{args.nproc} processes, batch B": (args.nproc, args.batch,
                                                 n_one),
            f"{args.nproc} processes, batch {args.nproc} B": (
                args.nproc, args.batch * args.nproc, n_weak)}
    result = {"card": card, "nproc": args.nproc, "batch": args.batch,
              "steps": args.steps, "runs": {}}
    rows, dirs = {}, {}
    for i, (name, (nproc, batch, chunks)) in enumerate(runs.items()):
        dirs[name] = os.path.join(args.workdir, f"run{i + 1}")
        rows[name] = train(dirs[name], data, nproc, batch, chunks, args)
        ms = step_ms(rows[name])
        result["runs"][name] = {
            "step_ms": ms, "samples_per_s":
                batch * args.chunk_len / ms * 1e3,
            "step_times_ms": [round(float(v), 2) for v in np.diff(
                [0.0] + [float(r["time"]) for r in rows[name]]) * 1e3]}
        print(f"{name}: {len(rows[name])} steps, step {ms:.2f} ms (median "
              f"of steps 3..), {result['runs'][name]['samples_per_s']:.4e} "
              f"samples/s on {card}")
    names = list(runs)
    check = compare(dirs[names[0]], dirs[names[1]], rows[names[0]],
                    rows[names[1]])
    result["run2_vs_run1"] = check
    weak = result["runs"][names[2]]["samples_per_s"] / (
        args.nproc * result["runs"][names[0]]["samples_per_s"])
    result["weak_scaling_efficiency"] = weak
    print(f"run 2 against run 1: {check}")
    print(f"weak scaling: {args.nproc} cards give {weak:.3f} of "
          f"{args.nproc} x one card's samples/s on {card}")
    print(json.dumps(result))
    return 0 if check["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
