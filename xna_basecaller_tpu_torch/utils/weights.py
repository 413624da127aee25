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

The CTC (QuartzNet) family's tree (``models/ctc_model.py``) maps key for
key, '/' for '.', its batchnorm running stats (buffers here) included:

  blocks/{i}/convs/{j}/tcs/{conv|depthwise|pointwise}/w [k, in/g, out]
  blocks/{i}/convs/{j}/bn/{scale, bias, mean, var}
  blocks/{i}/residual/tcs/conv/w, blocks/{i}/residual/bn/...
  decoder/{w [1, in, C], b}
  -> the same names with '.', convolution weights [out, in/g, k]
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
            state[f"conv.{parts[1]}.{name}"] = swap_layout(key, arr)
        elif parts[0] == "rnn" and len(parts) == 3 \
                and parts[2] in ("w_ih", "w_hh", "bias"):
            state[f"rnn.{parts[1]}.{parts[2]}"] = arr
        elif parts[0] in ("head", "head_ext") and len(parts) == 2 \
                and parts[1] in ("w", "b"):
            state[f"{parts[0]}.{parts[1]}"] = arr
        elif _is_ctc_key(parts):
            state[".".join(parts)] = swap_layout(key, arr)
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
    if _is_ctc_key(parts):
        return "/".join(parts)
    raise KeyError(f"unexpected parameter {name!r}")


_BN_LEAVES = ("scale", "bias", "mean", "var")


def _is_ctc_key(parts: list[str]) -> bool:
    """A key of the CTC family's tree, split at '/' or '.'."""
    if parts[0] == "decoder":
        return len(parts) == 2 and parts[1] in ("w", "b")
    if parts[0] != "blocks" or len(parts) < 5 or not parts[1].isdigit():
        return False
    if parts[2] == "convs" and parts[3].isdigit():
        rest = parts[4:]
    elif parts[2] == "residual":
        rest = parts[3:]
    else:
        return False
    return (rest[:1] == ["tcs"] and len(rest) == 3
            and rest[1] in ("conv", "depthwise", "pointwise")
            and rest[2] == "w") \
        or (rest[:1] == ["bn"] and len(rest) == 2 and rest[1] in _BN_LEAVES)


def swap_layout(key: str, arr: np.ndarray) -> np.ndarray:
    """The array of JAX key ``key`` in the other package's layout: a
    convolution weight (``conv/{i}/w``, and the CTC family's ``.../w``)
    transposed between [out, in, k] and [k, in, out] (either way), anything
    else as it is."""
    parts = key.split("/")
    if parts[-1] == "w" and parts[0] in ("conv", "blocks", "decoder"):
        return arr.transpose(2, 1, 0)
    return arr


def params_to_jax(state: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A state_dict -> the JAX package's flat checkpoint mapping ('/'-joined
    keys, f32 arrays, convolution weights as [k, in, out])."""
    flat = {}
    for name, t in state.items():
        key = jax_key(name)
        flat[key] = np.ascontiguousarray(
            swap_layout(key, t.detach().float().cpu().numpy()))
    return flat
