"""``xnacall export`` — export a model to a JSON weights dict.

Port of ``xna_basecaller_tpu/cli/export.py`` (reference surface:
ub-bonito/bonito/cli/export.py: guppy-style JSON with the fixed blank
score folded into padded head weights, export.py:45-64), writing JAX's
JSON byte for byte: the weights are loaded on ``--device`` and written in
the JAX package's layout (``utils/weights.py::params_to_jax``).  The CRF
family only, as in JAX.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


class NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.floating, np.integer)):
            return obj.item()
        return super().default(obj)


def main(args):
    from xna_basecaller_tpu_torch.utils.model_io import load_model
    from xna_basecaller_tpu_torch.utils.weights import params_to_jax

    model, cfg = load_model(args.model_directory, device=args.device,
                            weights=args.weights or None)
    if cfg.is_ctc:
        raise SystemExit("xnacall export: the CRF family only (a [[block]] "
                         "config has no conv/rnn/head layers)")
    flat = params_to_jax(model.state_dict())
    enc = cfg.encoder
    out = {
        "alphabet": cfg.alphabet,
        "state_len": cfg.state_len,
        "stride": enc.stride,
        "features": enc.features,
        "blank_score": enc.blank_score,
        "scale": enc.scale,
        "layers": [],
    }
    for i in range(len(model.conv)):
        out["layers"].append({
            "type": "convolution", "index": i,
            "W": flat[f"conv/{i}/w"], "b": flat[f"conv/{i}/b"],
        })
    for i in range(len(model.rnn)):
        out["layers"].append({
            "type": "lstm", "index": i, "reverse": (i % 2 == 0),
            "iW": flat[f"rnn/{i}/w_ih"].T.reshape(4, enc.features, -1),
            "sW": flat[f"rnn/{i}/w_hh"].T.reshape(
                4, enc.features, enc.features),
            "b": flat[f"rnn/{i}/bias"].reshape(4, enc.features),
        })
    head_w, head_b = flat["head/w"], flat["head/b"]
    if enc.blank_score is not None and args.fold_blanks:
        # fold the fixed blank score into padded W/b columns
        # (reference export.py:45-64): atanh(blank/scale) as a bias column
        # with zero weights per state.
        n_base, ns = cfg.n_base, cfg.n_state
        W = head_w.reshape(enc.features, ns, n_base)
        b = head_b.reshape(ns, n_base)
        blank_b = np.arctanh(
            np.clip(enc.blank_score / enc.scale, -0.999999, 0.999999))
        Wp = np.concatenate(
            [np.zeros((enc.features, ns, 1), W.dtype), W], axis=2)
        bp = np.concatenate(
            [np.full((ns, 1), blank_b, b.dtype), b], axis=1)
        head_w, head_b = Wp.reshape(enc.features, -1), bp.reshape(-1)
    out["layers"].append({
        "type": "global_norm", "W": head_w, "b": head_b,
    })
    with open(args.output, "w") as fh:
        json.dump(out, fh, cls=NumpyEncoder)
    print(f"> exported to {args.output}")


def argparser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    parser.add_argument("model_directory")
    parser.add_argument("--output", default="model.json")
    parser.add_argument("--device", default="cuda",
                        help="torch device the weights are loaded on")
    parser.add_argument("--weights", default=0, type=int)
    parser.add_argument("--fold-blanks", action="store_true", default=True)
    return parser
