"""Checkpoint save/load with the reference's epoch-numbered contract.

Port of ``xna_basecaller_tpu/train/checkpoint.py``: ``weights_{epoch}.npz``
every epoch, ``optim_{epoch}.npz`` every ``save_optim_every``, resume from
the highest epoch in the workdir (with an optimizer file, when the
optimizer is restored), never from the reserved pseudo-epochs 90 (SWA
candidate) and 99 (best-epoch alias), and ``link_best_epoch``.

Both files are flat npz archives written atomically, keyed and laid out
as the JAX package writes them, so that each package resumes from the
other's: ``weights_N.npz`` by '/'-joined parameter keys
(``utils/weights.py``), ``optim_N.npz`` by optax's state tree
(``1/0/count``, ``1/0/mu/<key>``, ``1/0/nu/<key>``, ``1/2/count``; under
``inner_states/train/inner_state/`` with frozen parameters), which
``train/loop.py::Optimizer`` writes and reads.
"""

from __future__ import annotations

import os
import re
from glob import glob

import numpy as np

from xna_basecaller_tpu_torch.utils.fileio import atomic_output

# Pseudo-epoch ids that are candidates/aliases, not training progress:
# 99 = best-epoch symlink (link_best_epoch), 90 = an SWA tail-average
# candidate.  Inference "latest" loading includes them on purpose; training
# resume ignores them.
RESERVED_EPOCHS = frozenset({90, 99})


def save_flat(flat: dict[str, np.ndarray], path: str) -> None:
    """Atomic write (a ".tmp-" prefixed temporary renamed into place), so
    that a kill mid-save never leaves a truncated archive that a relaunch
    takes for a checkpoint."""
    with atomic_output(path, "wb") as fh:
        np.savez(fh, **flat)


def load_flat(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def save_checkpoint(workdir: str, epoch: int, weights: dict[str, np.ndarray],
                    optim: dict[str, np.ndarray] | None = None,
                    save_optim: bool = True) -> None:
    os.makedirs(workdir, exist_ok=True)
    save_flat(weights, os.path.join(workdir, f"weights_{epoch}.npz"))
    if optim is not None and save_optim:
        save_flat(optim, os.path.join(workdir, f"optim_{epoch}.npz"))


def mark_reserved(workdir: str, epoch: int) -> None:
    """Sidecar marker declaring weights_{epoch} a pseudo-epoch artifact."""
    with open(os.path.join(workdir, f"weights_{epoch}.reserved"), "w"):
        pass


def _is_marked_reserved(workdir: str, epoch: int) -> bool:
    return os.path.exists(
        os.path.join(workdir, f"weights_{epoch}.reserved"))


def _epochs(workdir: str, prefix: str) -> set[int]:
    files = glob(os.path.join(workdir, f"{prefix}_*.npz"))
    return {int(re.sub(r".*_([0-9]+)\.npz", r"\1", f)) for f in files}


def latest_epoch(workdir: str, with_optim: bool = False,
                 exclude_reserved: bool = False) -> int | None:
    """Highest epoch with weights (and an optimizer file).  With
    ``exclude_reserved``, a reserved id is skipped when it has a marker or
    stands alone (no epoch r-1 beside it); 90 next to 89 is real progress."""
    weights = _epochs(workdir, "weights")
    if exclude_reserved:
        weights -= {r for r in RESERVED_EPOCHS & weights
                    if _is_marked_reserved(workdir, r)
                    or r - 1 not in weights}
    if with_optim:
        weights &= _epochs(workdir, "optim")
    return max(weights, default=None)


def load_checkpoint(workdir: str, with_optim: bool = False,
                    epoch: int | None = None):
    """Resume state: (epoch, weights or None, optimizer state or None).

    epoch=None picks the latest real epoch (with an optimizer file when
    ``with_optim``), never a reserved pseudo-epoch; epoch 0 when there is
    nothing to load."""
    if epoch is None:
        epoch = latest_epoch(workdir, with_optim=with_optim,
                             exclude_reserved=True)
    if epoch is None:
        return 0, None, None
    weights = load_flat(os.path.join(workdir, f"weights_{epoch}.npz"))
    optim = None
    opath = os.path.join(workdir, f"optim_{epoch}.npz")
    if with_optim and os.path.exists(opath):
        optim = load_flat(opath)
    return epoch, weights, optim


def link_best_epoch(workdir: str, epoch: int, alias: int = 99) -> None:
    """Symlink weights_{alias} -> the best epoch's weights, marked
    reserved."""
    link = os.path.join(workdir, f"weights_{alias}.npz")
    if os.path.islink(link) or os.path.exists(link):
        os.remove(link)
    os.symlink(f"weights_{epoch}.npz", link)
    mark_reserved(workdir, alias)
