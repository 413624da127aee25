"""``xnacall view`` — print model architecture, params, alphabet.

Port of ``xna_basecaller_tpu/cli/view.py`` (reference surface:
ub-bonito/bonito/cli/view.py), printing the same lines.  As in JAX, it
describes the CRF model of the config's encoder whatever the config's
family.  It computes nothing: the model is built on the ``meta`` device,
where its parameters have shapes and no storage.
"""

from __future__ import annotations

import argparse
from dataclasses import replace


def main(args):
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.models.crf_model import Model

    cfg = config_lib.load(args.model_directory)
    # the CRF model JAX's view builds of any config (blocks ignored)
    model = Model(replace(cfg, blocks=(),
                          package=config_lib.ModelConfig.package),
                  device="meta", seed=None)
    enc = cfg.encoder
    print(f"alphabet: {cfg.alphabet}  state_len: {cfg.state_len}  "
          f"n_state: {cfg.n_state}  n_score: {cfg.n_score}")
    print(f"encoder: conv({cfg.input_features}->{enc.first_conv_size}, k5) "
          f"-> conv({enc.first_conv_size}->{enc.second_conv_size}, k5) "
          f"-> conv({enc.second_conv_size}->{enc.features}, "
          f"k{enc.winlen}, stride {enc.stride})")
    dirs = ["rev" if (i % 2 == 0) else "fwd"
            for i in range(enc.num_rnn_layers)]
    print(f"rnn: {enc.num_rnn_layers} x LSTM({enc.features}) "
          f"[{', '.join(dirs)}]")
    head = (cfg.n_base ** (cfg.state_len + 1)
            if enc.blank_score is not None else cfg.n_score)
    print(f"head: linear({enc.features} -> {head})"
          f" tanh x{enc.scale}  blank_score={enc.blank_score}")
    print(f"parameters: {sum(p.numel() for p in model.parameters()):,}")


def argparser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    parser.add_argument("model_directory")
    return parser
