"""Modified-base classifier model.

Port of ``xna_basecaller_tpu/mods/model.py`` as an ``nn.Module``: given a
fixed window of raw signal centred on a candidate site and the basecalled
sequence context, the logit that the canonical base is modified:

  conv(1 -> conv1, k, stride 2) -> ReLU -> conv(conv1 -> conv2, k,
  stride 2) -> ReLU -> flatten (position-major) -> concat one-hot context
  -> dense(hidden) -> ReLU -> dense(1)

The parameters keep the JAX layout (convolutions [k, in, out] (WIO),
dense [in, out]) and names (``c1.w``, ``c1.b``, ..., ``d2.b``), so that
``save_mods_model`` writes JAX's ``mods_weights.npz`` keys and arrays and
``load_mods_model`` reads either package's.  JAX pads the stride-2
convolutions ``"SAME"``: the total padding is max((ceil(W/2) - 1) * 2 + k
- W, 0), its smaller half on the left, so that the right side gets the
extra element (torch's ``padding="same"`` refuses stride 2); the padding
is added by hand.  The forward runs in f32 (TF32 off) on the model's
device.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xna_basecaller_tpu_torch.core.alphabet import BASES
from xna_basecaller_tpu_torch.models.crf_model import pin_f32_precision
from xna_basecaller_tpu_torch.utils.device import resolve_device

ALPHABET = BASES  # NACGTXY, matches the basecaller codes
LAYERS = ("c1", "c2", "d1", "d2")


@dataclass(frozen=True)
class ModsConfig:
    motif: str = "CG"        # canonical motif to screen
    motif_offset: int = 0    # index of the modifiable base within motif
    canonical: str = "C"     # canonical base letter (SAM MM base)
    mod_code: str = "m"      # SAM base-mod code (m = 5mC, a = 6mA, ...)
    mod_long_name: str = "5mC"
    sig_window: int = 64     # raw-signal samples centred on the site
    context: int = 4         # sequence context bases either side
    conv1: int = 16
    conv2: int = 32
    hidden: int = 64
    kernel: int = 5


def _shapes(cfg: ModsConfig) -> dict[str, tuple[tuple[int, ...], int]]:
    """Each layer's weight shape (JAX layout) and width."""
    w = cfg.sig_window
    for _ in range(2):
        w = (w + 1) // 2  # two stride-2 convs (SAME)
    flat = w * cfg.conv2
    ctx_feats = (2 * cfg.context + 1) * len(ALPHABET)
    return {"c1": ((cfg.kernel, 1, cfg.conv1), cfg.conv1),
            "c2": ((cfg.kernel, cfg.conv1, cfg.conv2), cfg.conv2),
            "d1": ((flat + ctx_feats, cfg.hidden), cfg.hidden),
            "d2": ((cfg.hidden, 1), 1)}


def init_mods_params(cfg: ModsConfig, seed: int = 0):
    """Random parameters {layer: {"w", "b"}} as numpy arrays, drawn from a
    ``torch.Generator`` with the JAX init's distributions (weights uniform
    in +-sqrt(6 / fan_in), biases 0)."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    for name, (shape, width) in _shapes(cfg).items():
        fan_in = math.prod(shape[:-1])
        bound = math.sqrt(6.0 / fan_in)
        w = torch.empty(shape).uniform_(-bound, bound, generator=g)
        params[name] = {"w": w.numpy(), "b": np.zeros(width, np.float32)}
    return params


class _Layer(nn.Module):
    def __init__(self, shape, width: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(shape))
        self.b = nn.Parameter(torch.zeros(width))


def _same_stride2(x: torch.Tensor, k: int) -> torch.Tensor:
    """XLA's "SAME" padding of a stride-2 convolution, added by hand."""
    W = x.shape[-1]
    pad = max((-(-W // 2) - 1) * 2 + k - W, 0)
    return F.pad(x, (pad // 2, pad - pad // 2))


class ModsModel(nn.Module):
    """The classifier of ``cfg``: parameters from ``params`` (a tree as
    ``init_mods_params`` gives it), else random from ``seed``."""

    def __init__(self, cfg: ModsConfig = ModsConfig(), params=None,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        for name, (shape, width) in _shapes(cfg).items():
            setattr(self, name, _Layer(shape, width))
        self.load_params(params if params is not None
                         else init_mods_params(cfg, seed))
        self.to(dev)
        pin_f32_precision()

    @torch.no_grad()
    def load_params(self, params) -> None:
        for name in LAYERS:
            for k in ("w", "b"):
                getattr(getattr(self, name), k).copy_(torch.from_numpy(
                    np.array(params[name][k], np.float32)))

    def params(self) -> dict[str, dict[str, np.ndarray]]:
        """The parameter tree as numpy arrays, in the JAX layout and in the
        order of a JAX tree that went through ``jax.tree`` (sorted keys:
        ``b`` before ``w``), as ``fit`` returns it there, so that
        ``save_mods_model`` writes the members in JAX's order."""
        return {name: {k: getattr(getattr(self, name), k).detach().cpu()
                       .numpy() for k in ("b", "w")} for name in LAYERS}

    def forward(self, sig: torch.Tensor, ctx_codes: torch.Tensor):
        """sig [N, sig_window] f32, ctx_codes [N, 2*context+1] (ALPHABET
        codes) -> mod logits [N]."""
        x = sig.float()[:, None, :]                       # [N, 1, W]
        for name in ("c1", "c2"):
            layer = getattr(self, name)
            w = layer.w.permute(2, 1, 0)                  # [out, in, k]
            x = F.relu(F.conv1d(_same_stride2(x, w.shape[2]), w, layer.b,
                                stride=2))
        x = x.transpose(1, 2).reshape(x.shape[0], -1)     # [N, W' * C]
        onehot = F.one_hot(ctx_codes.long(), len(ALPHABET)).to(x.dtype)
        x = torch.cat([x, onehot.reshape(x.shape[0], -1)], -1)
        x = F.relu(x @ self.d1.w + self.d1.b)
        return (x @ self.d2.w + self.d2.b)[:, 0]


def mods_forward(model: ModsModel, sig, ctx_codes) -> torch.Tensor:
    """The logits of numpy or tensor inputs, on the model's device."""
    dev = next(model.parameters()).device
    return model(torch.as_tensor(np.asarray(sig, np.float32), device=dev),
                 torch.as_tensor(np.asarray(ctx_codes, np.int64), device=dev))


def save_mods_model(dirname: str, cfg: ModsConfig, params) -> None:
    """``mods_config.json`` and ``mods_weights.npz`` as JAX writes them;
    ``params`` a ``ModsModel`` or its parameter tree."""
    if isinstance(params, ModsModel):
        params = params.params()
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "mods_config.json"), "w") as fh:
        json.dump(asdict(cfg), fh, indent=2)
    flat = {}
    for layer, tree in params.items():
        for k, v in tree.items():
            flat[f"{layer}.{k}"] = np.asarray(v)
    np.savez(os.path.join(dirname, "mods_weights.npz"), **flat)


def load_mods_model(dirname: str, device: str | torch.device = "cuda"):
    """(cfg, ModsModel on ``device``) from either package's files."""
    with open(os.path.join(dirname, "mods_config.json")) as fh:
        cfg = ModsConfig(**json.load(fh))
    params: dict = {}
    with np.load(os.path.join(dirname, "mods_weights.npz")) as data:
        for key in data.files:
            layer, name = key.split(".")
            params.setdefault(layer, {})[name] = data[key]
    return cfg, ModsModel(cfg, params, device=device)
