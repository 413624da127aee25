"""Carry weights across packages: ``params_from_jax`` maps the JAX
package's parameter tree, or its flat checkpoint (``weights_N.npz``), to
this package's ``Model.state_dict()``, and ``params_to_jax`` maps a
state_dict back to the flat checkpoint, so that each package loads the
other's ``weights_N.npz``.

JAX checkpoint keys (``train/checkpoint.py:23-68`` there) are '/'-joined
tree paths:

  conv/{i}/w [k, in, out], conv/{i}/b   -> conv.{i}.weight [out, in, k], .bias
  rnn/{i}/{w_ih [in,4H], w_hh [H,4H], bias [4H]}   -> rnn.{i}.<same>
  head/{w [F, C'], b}, head_ext/{w, b}  -> head.{w, b}, head_ext.{w, b}

Only the convolution weights change layout; ``w_hh`` stays [H, 4H], as
the LSTM kernel reads it.  Gate order is i, f, g, o and there is no
``bias_hh`` on either side.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree, dtype=np.float32)}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def params_from_jax(tree_or_flat) -> dict[str, torch.Tensor]:
    """A JAX parameter tree (arrays of any kind numpy can read) or a flat
    '/'-keyed mapping, e.g. an open ``weights_N.npz`` -> state_dict."""
    if isinstance(tree_or_flat, Mapping) and all(
            "/" in k for k in tree_or_flat):
        flat = {k: np.asarray(v, dtype=np.float32)
                for k, v in tree_or_flat.items()}
    else:
        flat = _flatten(tree_or_flat)
    state = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "conv" and len(parts) == 3 and parts[2] in "wb":
            name = "weight" if parts[2] == "w" else "bias"
            if name == "weight":
                arr = arr.transpose(2, 1, 0)
            state[f"conv.{parts[1]}.{name}"] = arr
        elif parts[0] == "rnn" and len(parts) == 3 \
                and parts[2] in ("w_ih", "w_hh", "bias"):
            state[f"rnn.{parts[1]}.{parts[2]}"] = arr
        elif parts[0] in ("head", "head_ext") and len(parts) == 2 \
                and parts[1] in ("w", "b"):
            state[f"{parts[0]}.{parts[1]}"] = arr
        else:
            raise KeyError(f"unexpected JAX parameter {key!r}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in state.items()}


def jax_key(name: str) -> str:
    """The JAX checkpoint key of a state_dict entry, e.g. ``conv.0.weight``
    -> ``conv/0/w``, ``rnn.1.w_hh`` -> ``rnn/1/w_hh``, ``head.b`` ->
    ``head/b``."""
    parts = name.split(".")
    if parts[0] == "conv" and len(parts) == 3 \
            and parts[2] in ("weight", "bias"):
        return f"conv/{parts[1]}/{parts[2][0]}"
    if parts[0] == "rnn" and len(parts) == 3:
        return "/".join(parts)
    if parts[0] in ("head", "head_ext") and len(parts) == 2:
        return "/".join(parts)
    raise KeyError(f"unexpected parameter {name!r}")


def params_to_jax(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A state_dict -> the JAX package's flat checkpoint mapping ('/'-joined
    keys, f32 arrays, convolution weights as [k, in, out])."""
    flat = {}
    for name, t in state.items():
        arr = t.detach().float().cpu().numpy()
        if name.startswith("conv.") and name.endswith(".weight"):
            arr = arr.transpose(2, 1, 0)
        flat[jax_key(name)] = np.ascontiguousarray(arr)
    return flat
