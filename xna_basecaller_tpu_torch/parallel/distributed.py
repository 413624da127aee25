"""The multi-process runtime: join torch.distributed, read this rank's
place, and the collectives the trainer and the evaluation use.

Port of ``xna_basecaller_tpu/parallel/distributed.py:1-106``.  JAX joins
``jax.distributed`` and spans every host's devices with one mesh; here
each GPU is one process, started by ``torch.distributed.run`` (which sets
``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``) or given its place explicitly:

    from xna_basecaller_tpu_torch.parallel import distributed as dist
    from xna_basecaller_tpu_torch.parallel import mesh as mesh_lib
    dist.initialize()                       # no-op single-process
    mesh = mesh_lib.make_mesh(dist.local_device())
    ...
    chunks = dist.global_batch(mesh, local_chunks)   # this rank's rows

The backend is NCCL on the card and gloo when the caller asks for the
CPU.  Inference fans reads out round-robin (``shard_reads``), as JAX's
does, and evaluation fans metrics in by their mean (``all_gather_metrics``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from xna_basecaller_tpu_torch.utils.device import resolve_device

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True under ``torch.distributed.run`` (its environment is set)."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """``device``, or under the launcher ``cuda:LOCAL_RANK`` where
    ``device`` names the card without an index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str | torch.device = "cuda") -> None:
    """Join torch.distributed: from the launcher's environment, or from
    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id``.  A no-op for a single process started without the
    launcher, or when already joined.  NCCL with the rank on
    ``local_device(device)`` (the current card where that has no index),
    gloo when ``device`` is the CPU."""
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not launched():
        return
    dev = resolve_device(local_device(device))
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init,
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1)


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_batch(mesh, *local_arrays):
    """This rank's rows of a global batch, on its device.  Each rank
    passes its own rows; their counts must be equal across ranks (pad the
    tail batch), as JAX demands."""
    n = local_arrays[0].shape[0]
    if any(a.shape[0] != n for a in local_arrays):
        raise ValueError("local arrays of different row counts")
    if mesh.world_size > 1:
        counts = all_gather_rows(mesh, torch.tensor([n], device=mesh.device))
        if len(set(counts.tolist())) != 1:
            raise ValueError(f"local batch sizes differ across ranks: "
                             f"{counts.tolist()}")
    out = tuple(
        (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(a))).to(mesh.device)
        for a in local_arrays)
    return out if len(out) > 1 else out[0]


def shard_reads(reads, process_id: int | None = None,
                n_processes: int | None = None):
    """Deal reads round-robin to the processes (inference fan-out)."""
    pid = process_id if process_id is not None else process_index()
    n = n_processes if n_processes is not None else process_count()
    for i, read in enumerate(reads):
        if i % n == pid:
            yield read


def all_gather_rows(mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes) concatenated on axis 0 in
    rank order, on this rank's device; ``tensor`` itself with one rank."""
    if mesh.world_size == 1:
        return tensor
    comm = mesh.comm_device
    local = tensor.to(comm).contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
    dist.all_gather(parts, local)
    return torch.cat(parts).to(tensor.device)


def all_reduce_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on ``t``'s device."""
    buf = t.to(mesh.comm_device)
    dist.all_reduce(buf)
    return buf.to(t.device)


def all_gather_metrics(values: dict[str, float],
                       mesh=None) -> dict[str, float]:
    """The mean of each scalar metric over the processes (eval fan-in),
    by one ``all_reduce`` in f64."""
    if process_count() == 1:
        return dict(values)
    keys = sorted(values)
    comm = (mesh.comm_device if mesh is not None
            else torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64,
                     device=comm)
    dist.all_reduce(t)
    t /= process_count()
    return {k: float(v) for k, v in zip(keys, t.tolist())}
