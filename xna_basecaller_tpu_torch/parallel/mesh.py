"""The data-parallel layout: this process's rank, the world size and its
device, and the helpers that place a global batch on it.

Port of ``xna_basecaller_tpu/parallel/mesh.py:1-72``.  JAX runs one
process over a 1-D ``data`` mesh of devices: parameters are replicated,
the batch is sharded on axis 0, and XLA inserts the gradient psum.  The
torch idiom is one process per GPU (``torch.distributed.run``): each rank
holds a full copy of the parameters (``replicate`` broadcasts rank 0's),
feeds its own contiguous slice of every global batch (``shard_batch``:
the rows JAX places on the devices of the same position in the mesh),
and the trainer all-reduces the gradients itself
(``train/loop.py::train_step``).  So the "mesh" here is a rank, a world
size and a device; with torch.distributed not initialised it is rank 0 of
1, and every helper is the identity on the data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from xna_basecaller_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D data-parallel layout."""

    rank: int
    world_size: int
    device: torch.device

    @property
    def comm_device(self) -> torch.device:
        """Where a collective's tensors live: the card under NCCL, the CPU
        under gloo (or with no process group)."""
        if dist.is_initialized() and dist.get_backend() == "nccl":
            return self.device
        return torch.device("cpu")


def make_mesh(device: str | torch.device = "cuda") -> Mesh:
    """This process's place in the data-parallel layout, from the process
    group when torch.distributed is initialised (rank 0 of 1 otherwise),
    on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return Mesh(dist.get_rank(), dist.get_world_size(), dev)
    return Mesh(0, 1, dev)


def pad_to_multiple(batch, multiple: int):
    """Pad axis 0 with zeros to a multiple of ``multiple`` (the world
    size); returns (padded, n_real).  Takes a numpy array or a tensor and
    returns the same kind."""
    n = batch.shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, n
    pad = multiple - rem
    if isinstance(batch, torch.Tensor):
        return torch.cat([batch, batch.new_zeros(
            (pad,) + tuple(batch.shape[1:]))]), n
    padding = np.zeros((pad,) + batch.shape[1:], batch.dtype)
    return np.concatenate([batch, padding], axis=0), n


def _rows(mesh: Mesh, n: int) -> slice:
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not divide over {mesh.world_size} "
                         "ranks: pad_to_multiple first")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _to_device(a, device: torch.device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's contiguous slice of global host arrays [B, ...] on its
    device (B a multiple of the world size)."""
    out = tuple(_to_device(a[_rows(mesh, a.shape[0])], mesh.device)
                for a in arrays)
    return out if len(out) > 1 else out[0]


def shard_stacked_batch(mesh: Mesh, *arrays):
    """[K, B, ...] step stacks: every rank sees every step, and its slice
    of the batch axis (axis 1)."""
    out = tuple(_to_device(a[:, _rows(mesh, a.shape[1])], mesh.device)
                for a in arrays)
    return out if len(out) > 1 else out[0]


@torch.no_grad()
def replicate(mesh: Mesh, tensors):
    """Overwrite ``tensors`` (e.g. ``model.state_dict().values()`` and the
    optimizer's state) in place with rank 0's values; returns them as a
    list.  The identity with one rank."""
    tensors = list(tensors)
    if mesh.world_size == 1:
        return tensors
    comm = mesh.comm_device
    for t in tensors:
        buf = t if t.device == comm else t.to(comm)
        dist.broadcast(buf, src=0)
        if buf is not t:
            t.copy_(buf)
    return tensors
