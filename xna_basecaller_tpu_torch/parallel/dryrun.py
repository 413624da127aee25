"""A multi-process dry run of the data-parallel training step, and of the
sharded scorer over the same devices.

The port's counterpart of ``__graft_entry__.py:27`` ``dryrun_multichip``:
N processes (gloo on the CPU, NCCL with one card each) join one process
group and run ONE data-parallel ``train_step`` of the flagship structure
at ``features=64`` (JAX's dry-run model) on a seeded global batch, each on
its slice of it, then ``Trainer.validate`` on their slices of a
validation set whose last batch is one row; rank 0 writes the step's
loss, grad_norm, the sum of |parameters| after the update, the
validation's loss, mean and median accuracy, and the ranks' mean metrics.
The parent then runs the same step and validation in one process on the
whole batches and fails unless both agree within ``test_parallel.py``'s
tolerances (loss rtol 1e-5, grad_norm 1e-4, parameter sum 1e-5; the
validation rtol 1e-6: the same per-row values, gathered), and scores a
batch through ``make_sharded_scorer`` over the N devices.

    python -m xna_basecaller_tpu_torch.parallel.dryrun N [--device cpu]
        [--config TOML] [--weights NPZ] [--batch B] [--chunk T]
        [--target-len L] [--zero-rows LO:HI] [--grad-accum-split K]
        [--out result.json]

``--config`` and ``--weights`` (a ``weights_N.npz`` in the JAX package's
layout) replace the model; ``--zero-rows`` gives the global rows LO..HI-1
length 0 (the padding rows of a batch).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import sys

import numpy as np
import torch

TOLERANCES = {"loss": 1e-5, "grad_norm": 1e-4, "param_sum": 1e-5}
VALIDATION_RTOL = 1e-6


def _model(opts: dict, device: str):
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.core.config import EncoderConfig, ModelConfig
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.utils.weights import params_from_jax

    cfg = (config_lib.load(opts["config"]) if opts.get("config") else
           ModelConfig(encoder=EncoderConfig(features=64, num_rnn_layers=5)))
    if not opts.get("weights"):
        return Model(cfg, device=device, seed=0)
    model = Model(cfg, device="cpu", seed=None)
    with np.load(opts["weights"]) as npz:
        model.load_state_dict(params_from_jax({k: npz[k] for k in npz.files}))
    return model.to(device)


def _global_batch(opts: dict, n_base: int):
    """The seeded global batch (JAX's dry run: normal chunks, targets in
    1..n_base, every length ``target_len``), some rows made length 0."""
    rng = np.random.default_rng(opts.get("seed", 0))
    B, T, L = opts["batch"], opts["chunk"], opts["target_len"]
    chunks = rng.normal(size=(B, T)).astype(np.float32)
    targets = rng.integers(1, n_base + 1, size=(B, L)).astype(np.int32)
    lengths = np.full((B,), L, np.int32)
    if opts.get("zero_rows"):
        lo, hi = (int(v) for v in opts["zero_rows"].split(":"))
        lengths[lo:hi] = 0
    return chunks, targets, lengths


def _step(model, opts: dict, batch, mesh=None) -> dict:
    """One ``train_step`` (f32, lr 1e-3 flat, AdamW's defaults); the
    returned numbers are the global step's on every rank."""
    from xna_basecaller_tpu_torch.train.loop import make_optimizer, train_step

    optimizer = make_optimizer(model, lambda _: opts.get("lr", 1e-3))
    loss, grad_norm = train_step(
        model, optimizer, *batch, compute_dtype=torch.float32,
        grad_accum_split=opts.get("grad_accum_split", 1), mesh=mesh)
    return {"loss": float(loss), "grad_norm": float(grad_norm),
            "param_sum": float(sum(p.detach().double().abs().sum().item()
                                   for p in model.parameters()))}


def _validate(model, opts: dict, mesh=None) -> list[float]:
    """``Trainer.validate`` (f32) over a seeded validation set of
    ``batch + 1`` rows in batches of ``batch``: an uneven tail of one row,
    which the ranks pad.  Returns [loss, mean accuracy, median]."""
    from xna_basecaller_tpu_torch.data.ctc_data import ChunkDataset
    from xna_basecaller_tpu_torch.train.loop import Trainer

    opts = {**opts, "batch": opts["batch"] + 1, "zero_rows": None,
            "seed": opts.get("seed", 0) + 1}
    valid = ChunkDataset(*_global_batch(opts, model.cfg.n_base))
    trainer = Trainer(model, [], valid, batchsize=opts["batch"] - 1,
                      compute_dtype=torch.float32, mesh=mesh)
    return list(trainer.validate())


def _worker(rank: int, n: int, port: int, device: str, opts: dict,
            out: str) -> None:
    """One rank: join the group, run the step on its slice, write the
    result from rank 0."""
    from xna_basecaller_tpu_torch.parallel import distributed as dist
    from xna_basecaller_tpu_torch.parallel import mesh as mesh_lib

    if device == "cpu":
        torch.set_num_threads(1)
    dev = "cpu" if device == "cpu" else f"cuda:{rank}"
    dist.initialize(f"localhost:{port}", n, rank, device=dev)
    try:
        mesh = mesh_lib.make_mesh(dev)
        model = _model(opts, dev)
        batch = [mesh_lib.pad_to_multiple(a, n)[0]
                 for a in _global_batch(opts, model.cfg.n_base)]
        result = _step(model, opts, mesh_lib.shard_batch(mesh, *batch),
                       mesh=mesh)
        result["validation"] = _validate(model, opts, mesh)
        result["metrics"] = dist.all_gather_metrics(
            {"loss": result["loss"], "pid": float(rank)}, mesh)
        result["process_count"] = dist.process_count()
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(result, fh)
    finally:
        dist.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     out: str | None = None, timeout: float = 600.0,
                     **opts) -> dict:
    """Run the data-parallel step over ``n_devices`` processes and check
    it against the single-process step; returns {"dp": ..., "single":
    ...}.  ``device`` "cpu" runs gloo processes on the CPU, "cuda" one
    process per card (NCCL)."""
    from xna_basecaller_tpu_torch.infer.sharded import make_sharded_scorer
    from xna_basecaller_tpu_torch.parallel import dryrun as this
    from xna_basecaller_tpu_torch.parallel.mesh import pad_to_multiple

    opts = {"batch": 2 * n_devices, "chunk": 400, "target_len": 40,
            **{k: v for k, v in opts.items() if v is not None}}
    if device != "cpu" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards, have "
                           f"{torch.cuda.device_count()}")
    out = out or os.path.join(os.getcwd(), "dryrun_result.json")
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=this._worker,
                         args=(rank, n_devices, port, device, opts, out))
             for rank in range(n_devices)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
        raise RuntimeError(f"a rank did not finish in {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with {codes}")
    with open(out) as fh:
        dp = json.load(fh)

    dev = "cpu" if device == "cpu" else "cuda:0"
    model = _model(opts, dev)
    # the padded global batch, as the ranks split it (and JAX pads it)
    batch = [torch.from_numpy(pad_to_multiple(a, n_devices)[0]).to(dev)
             for a in _global_batch(opts, model.cfg.n_base)]
    single = _step(model, opts, batch)
    single["validation"] = _validate(model, opts)
    if not np.isfinite(dp["loss"]):
        raise RuntimeError(f"the data-parallel loss is {dp['loss']}")
    for k, rtol in TOLERANCES.items():
        if not np.isclose(dp[k], single[k], rtol=rtol, atol=0.0):
            raise RuntimeError(
                f"data-parallel {k} {dp[k]!r} against one process's "
                f"{single[k]!r} (rtol {rtol})")
    if not np.allclose(dp["validation"], single["validation"],
                       rtol=VALIDATION_RTOL, atol=0.0, equal_nan=True):
        raise RuntimeError(
            f"data-parallel validation {dp['validation']} against one "
            f"process's {single['validation']} (rtol {VALIDATION_RTOL})")
    devices = ([torch.device("cpu")] * n_devices if device == "cpu" else
               [torch.device("cuda", i) for i in range(n_devices)])
    scorer = make_sharded_scorer(model, devices)
    paths = scorer(np.random.default_rng(1).normal(
        size=(opts["batch"], opts["chunk"])).astype(np.float32))
    if paths.shape[0] != opts["batch"]:
        raise RuntimeError(f"sharded scorer returned {paths.shape}")
    result = {"dp": dp, "single": single}
    with open(out, "w") as fh:
        json.dump(result, fh)
    print(f"dryrun_multichip({n_devices}, {device}): loss={dp['loss']:.6f} "
          f"grad_norm={dp['grad_norm']:.6f} (one process: "
          f"{single['loss']:.6f}, {single['grad_norm']:.6f}) "
          f"sharded_decode_ok={paths.shape}")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--batch", default=None, type=int)
    parser.add_argument("--chunk", default=None, type=int)
    parser.add_argument("--target-len", default=None, type=int)
    parser.add_argument("--zero-rows", default=None, metavar="LO:HI")
    parser.add_argument("--grad-accum-split", default=None, type=int)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, out=args.out,
                     config=args.config, weights=args.weights,
                     batch=args.batch, chunk=args.chunk,
                     target_len=args.target_len, zero_rows=args.zero_rows,
                     grad_accum_split=args.grad_accum_split)
    return 0


if __name__ == "__main__":
    sys.exit(main())
