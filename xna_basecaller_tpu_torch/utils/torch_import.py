"""Import reference PyTorch checkpoints (``weights_N.tar``) as this
package's state_dict.

Port of ``xna_basecaller_tpu/utils/torch_import.py:1-97``.  The reference
(bonito) publishes its models as torch state_dicts over its encoder Serial:
``encoder.<i>.conv.weight`` ... ``encoder.<i>.rnn.weight_ih_l0`` ...
``encoder.<i>.linear.weight``.  JAX maps them onto its parameter tree;
here they map straight onto ``Model.state_dict()``:

  conv : Conv1d weight [out, in, k] -> conv.<j>.weight as it is; bias
  lstm : weight_ih_l0 [4H, in] -> rnn.<j>.w_ih [in, 4H] (gate order i, f,
         g, o on both sides); weight_hh_l0 [4H, H] -> rnn.<j>.w_hh
         [H, 4H]; bias_ih_l0 -> rnn.<j>.bias; bias_hh_l0 (zero and frozen
         in the reference) is dropped, as JAX drops it
  head : linear.weight [out, in] -> head.w [in, out]; bias -> head.b (and
         linear_ext the same way, into head_ext)

The mapping is structural (the Serial's indices in order), so
DataParallel's ``module.`` prefix and renumbered Serials load alike.
``export_state_dict`` is its inverse, which writes a model in the
reference's layout (how the tests and ``chip_smoke.py`` make a
``weights_N.tar`` from seeded weights).
"""

from __future__ import annotations

import re

import torch


def import_state_dict(state_dict: dict, cfg) -> dict[str, torch.Tensor]:
    """A reference state_dict -> this package's state_dict for ``cfg``
    (f32, contiguous, on the CPU)."""
    groups: dict[int, dict[str, torch.Tensor]] = {}
    for k, v in state_dict.items():
        m = re.match(r"encoder\.(\d+)\.(.+)$", re.sub(r"^module\.", "", k))
        if m:
            groups.setdefault(int(m.group(1)), {})[m.group(2)] = \
                torch.as_tensor(v).detach().cpu().float()

    def f32(t):
        return t.contiguous().clone()

    state: dict[str, torch.Tensor] = {}
    n_conv = n_rnn = 0
    head = False
    for idx in sorted(groups):
        g = groups[idx]
        if "conv.weight" in g:
            state[f"conv.{n_conv}.weight"] = f32(g["conv.weight"])
            state[f"conv.{n_conv}.bias"] = f32(g["conv.bias"])
            n_conv += 1
        elif "rnn.weight_ih_l0" in g:
            state[f"rnn.{n_rnn}.w_ih"] = f32(g["rnn.weight_ih_l0"].T)
            state[f"rnn.{n_rnn}.w_hh"] = f32(g["rnn.weight_hh_l0"].T)
            state[f"rnn.{n_rnn}.bias"] = f32(g["rnn.bias_ih_l0"])
            n_rnn += 1
        elif "linear.weight" in g:
            head = True
            state["head.w"] = f32(g["linear.weight"].T)
            state["head.b"] = f32(g["linear.bias"])
            if "linear_ext.weight" in g:
                state["head_ext.w"] = f32(g["linear_ext.weight"].T)
                state["head_ext.b"] = f32(g["linear_ext.bias"])

    if not n_conv or not n_rnn or not head:
        raise ValueError(
            "state_dict does not look like a reference CRF encoder "
            f"(convs={n_conv}, rnns={n_rnn}, head={head})")
    if n_rnn != cfg.encoder.num_rnn_layers:
        raise ValueError(
            f"checkpoint has {n_rnn} LSTM layers, config expects "
            f"{cfg.encoder.num_rnn_layers}")
    return state


def load_torch_checkpoint(path: str, cfg) -> dict[str, torch.Tensor]:
    """A reference ``weights_N.tar`` -> this package's state_dict."""
    return import_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), cfg)


def export_state_dict(state: dict) -> dict[str, torch.Tensor]:
    """This package's state_dict -> the reference's: the convs at the
    Serial's indices 0.., its Permute next (no parameters), then the LSTMs
    (``bias_hh_l0`` zero), then the CRF head (and ``linear_ext``)."""
    n_conv = sum(1 for k in state if re.match(r"conv\.\d+\.weight$", k))
    n_rnn = sum(1 for k in state if re.match(r"rnn\.\d+\.w_ih$", k))
    out = {}
    for i in range(n_conv):
        out[f"encoder.{i}.conv.weight"] = state[f"conv.{i}.weight"]
        out[f"encoder.{i}.conv.bias"] = state[f"conv.{i}.bias"]
    for j in range(n_rnn):
        pre = f"encoder.{n_conv + 1 + j}.rnn."
        out[pre + "weight_ih_l0"] = state[f"rnn.{j}.w_ih"].T
        out[pre + "weight_hh_l0"] = state[f"rnn.{j}.w_hh"].T
        out[pre + "bias_ih_l0"] = state[f"rnn.{j}.bias"]
        out[pre + "bias_hh_l0"] = torch.zeros_like(state[f"rnn.{j}.bias"])
    pre = f"encoder.{n_conv + 1 + n_rnn}."
    out[pre + "linear.weight"] = state["head.w"].T
    out[pre + "linear.bias"] = state["head.b"]
    if "head_ext.w" in state:
        out[pre + "linear_ext.weight"] = state["head_ext.w"].T
        out[pre + "linear_ext.bias"] = state["head_ext.b"]
    return {k: v.detach().cpu().float().contiguous() for k, v in out.items()}
