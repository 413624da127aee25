"""Random weights of a configuration, made on the device from the seed.

One ``torch.randn`` over a flat f32 buffer on the target device, scaled
leaf by leaf in one product, then viewed as the leaves.  The leaf names
and shapes are those of a bonito-style CRF-LSTM model in the layout that
the port's ``Model.state_dict`` uses (LSTM ``w_ih [in, 4H]``, ``w_hh
[H, 4H]``, one bias; head ``w [F, C']``); both the program and the plain
reference take this dict, so neither makes weights of its own.

The convolutions take He's deviation sqrt(2 / fan_in) and their biases
that of uniform +-1 / sqrt(fan_in), as the port's initialisers do.  The
LSTMs and the head are scaled up from the port's initialisers, so that
the decode of random weights depends on the signal as a trained model's
does: LSTM input weights 2 / sqrt(H), recurrent weights 1.5 / sqrt(H),
biases 0, head 3 sqrt(2 / F).  With the port's own scales (1 / sqrt(H),
LSTM bias 0.5, head sqrt(2 / F)) some seeds decode nearly every frame as
a tie and others never move, so no comparison of calls could tell a
precision apart from a seed (``PERF.md`` §6).
"""

from __future__ import annotations

import math

import torch


def model_dims(model: dict) -> dict:
    """The sizes a configuration's ``model`` section implies."""
    enc = model["encoder"]
    labels = model["labels"]["labels"]
    n_base = len(labels) - 1
    state_len = model["global_norm"]["state_len"]
    return {
        "features": enc["features"], "layers": enc["num_rnn_layers"],
        "stride": enc["stride"], "winlen": enc["winlen"],
        "conv": (model["input"]["features"], enc["first_conv_size"],
                 enc["second_conv_size"], enc["features"]),
        "n_base": n_base, "state_len": state_len,
        "n_state": n_base ** state_len,
        "head_cols": n_base ** (state_len + 1),
        "n_score": (n_base + 1) * n_base ** state_len,
        "scale": enc["scale"], "blank_score": enc["blank_score"],
        "activation": enc["activation"], "alphabet": "".join(labels),
    }


def leaf_shapes(model: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, standard deviation) of every leaf, in order."""
    d = model_dims(model)
    c_in, c1, c2, F = d["conv"]
    convs = [(c_in, c1, 5), (c1, c2, 5), (c2, F, d["winlen"])]
    out = []
    for i, (ci, co, k) in enumerate(convs):
        fan = ci * k
        out += [(f"conv.{i}.weight", (co, ci, k), math.sqrt(2.0 / fan)),
                (f"conv.{i}.bias", (co,), 1.0 / math.sqrt(3.0 * fan))]
    for i in range(d["layers"]):
        out += [(f"rnn.{i}.w_ih", (F, 4 * F), 2.0 / math.sqrt(F)),
                (f"rnn.{i}.w_hh", (F, 4 * F), 1.5 / math.sqrt(F)),
                (f"rnn.{i}.bias", (4 * F,), 0.0)]
    out += [("head.w", (F, d["head_cols"]), 3.0 * math.sqrt(2.0 / F)),
            ("head.b", (d["head_cols"],), 1.0 / math.sqrt(3.0 * F))]
    return out


def make_weights(model: dict, seed: int,
                 device: str | torch.device) -> dict[str, torch.Tensor]:
    """{name: f32 tensor on ``device``}, drawn from ``seed``."""
    shapes = leaf_shapes(model)
    sizes = [math.prod(s) for _, s, _ in shapes]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([std for _, _, std in shapes], device=device),
        torch.tensor(sizes, device=device))
    flat.mul_(scale)
    out, offset = {}, 0
    for (name, shape, _), n in zip(shapes, sizes):
        out[name] = flat[offset:offset + n].view(shape)
        offset += n
    return out
