"""``xnacall train`` — train a model on ctc-data, on the card.

Port of ``xna_basecaller_tpu/cli/train.py`` (reference surface:
ub-bonito/bonito/cli/train.py) with every flag of the JAX command plus
``--device``.  The augmentations (``--spike``, ``--stitch``) and
``--profile`` (a JAX trace) are not ported yet: each is refused with an
error instead of being ignored.  Their knobs (``--ubs``, ``--ub-prop``
...) are accepted: JAX reads them only with ``--spike`` or ``--stitch``
(``need_bkps``) and trains without augmentation otherwise, as this
command does.  Without ``--config`` or ``--pretrained`` the flagship
``ModelConfig()`` is trained.
"""

from __future__ import annotations

import argparse
import os
import sys

# flag -> argparse dest of the options that are not ported yet
NOT_PORTED = {"--profile": "profile", "--spike": "spike", "--stitch": "stitch"}
# the augmentations' knobs, inert without --spike and --stitch
AUGMENT_KNOBS = (
    "--ubs", "--ub-prop", "--var-prop-ubs", "--no-mix-ubs", "--ub-pad",
    "--synth-prop-ubs", "--xna-ctc-dir", "--cand-sample-size",
    "--stitch-relax", "--weighted-pos-pick", "--permute-win-size",
    "--stitch-noise-std", "--stitch-noise-mode", "--noise-std", "--std-dist",
    "--fully-synth",
)
_FLAGS = {"--no-mix-ubs", "--stitch-relax", "--weighted-pos-pick",
          "--fully-synth", "--spike", "--stitch"}
_FLOATS = {"--ub-prop", "--var-prop-ubs", "--synth-prop-ubs",
           "--stitch-noise-std", "--noise-std"}
_INTS = {"--ub-pad", "--cand-sample-size", "--permute-win-size"}


def main(args):
    for flag, dest in NOT_PORTED.items():
        if getattr(args, dest) not in (None, False):
            sys.exit(f"xnacall train: {flag} is not ported to "
                     "xna_basecaller_tpu_torch yet")

    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.data.ctc_data import load_datasets
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.train.loop import Trainer
    from xna_basecaller_tpu_torch.utils.model_io import load_model

    workdir = os.path.expanduser(args.training_directory)
    if os.path.exists(workdir) and not args.force:
        sys.stderr.write(
            f"[error] {workdir} exists, use -f to force continue\n")
        exit(1)
    os.makedirs(workdir, exist_ok=True)

    train_data, valid_data = load_datasets(
        args.directory, limit=args.chunks or None,
        valid_limit=args.valid_chunks or None)

    if args.pretrained:
        model, cfg = load_model(
            args.pretrained, device=args.device, skip_top=args.skip_top,
            drop_rate=args.drop_rate, drop_rate_bottom=args.drop_rate_bottom,
            seed=args.seed)
    else:
        cfg = (config_lib.load(args.config) if args.config
               else config_lib.ModelConfig())
        model = Model(cfg, device=args.device, seed=args.seed)

    if len(cfg.labels) == 6:
        # 5-letter model (single UB letter): remap Y->X in targets
        # (reference data.py:81-82)
        train_data.replace_6_letter = True
        valid_data.replace_6_letter = True

    config_lib.save(cfg, os.path.join(workdir, "config.toml"))
    with open(os.path.join(workdir, "argv.txt"), "w") as fh:
        fh.write(" ".join(sys.argv) + "\n")

    frozen_predicate = None
    if args.freeze_bottom:
        # freeze everything except the top K rnn layers + head
        # (reference cli/train.py:134-158)
        n_rnn = cfg.encoder.num_rnn_layers
        keep = args.unfreeze_top

        def frozen_predicate(key: str) -> bool:
            if key.startswith("head"):
                return False
            if key.startswith("rnn/"):
                return int(key.split("/")[1]) < n_rnn - keep
            return True

    Trainer(
        model, train_data, valid_data,
        batchsize=args.batch, lr=args.lr, seed=args.seed,
        restore_optim=args.restore_optim,
        save_optim_every=args.save_optim_every,
        grad_accum_split=args.grad_accum_split,
        frozen_predicate=frozen_predicate,
    ).fit(workdir, epochs=args.epochs)


def argparser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    parser.add_argument("training_directory")
    parser.add_argument("--config", default=None)
    parser.add_argument("--pretrained", default="")
    parser.add_argument("--directory", default=None, required=True,
                        help="ctc-data directory")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    parser.add_argument("-f", "--force", action="store_true")
    parser.add_argument("--lr", default=5e-4, type=float)
    parser.add_argument("--seed", default=25, type=int)
    parser.add_argument("--epochs", default=5, type=int)
    parser.add_argument("--batch", default=64, type=int)
    parser.add_argument("--chunks", default=0, type=int)
    parser.add_argument("--valid-chunks", default=0, type=int)
    parser.add_argument("--grad-accum-split", default=1, type=int)
    parser.add_argument("--steps-per-dispatch", default=1, type=int,
                        help="accepted for the JAX command's sake: the K "
                             "steps run one after another (the same math)")
    parser.add_argument("--restore-optim", action="store_true")
    parser.add_argument("--save-optim-every", default=10, type=int)
    parser.add_argument("--skip-top", action="store_true",
                        help="drop CRF head weights from pretrained load")
    parser.add_argument("--drop-rate", default=None, type=float)
    parser.add_argument("--drop-rate-bottom", default=None, type=float)
    # freeze knobs
    parser.add_argument("--freeze-bottom", action="store_true")
    parser.add_argument("--unfreeze-top", default=3, type=int)
    not_ported = parser.add_argument_group(
        "not ported yet (each is refused with an error)")
    not_ported.add_argument("--profile", default=None)
    knobs = parser.add_argument_group(
        "augmentation knobs (read only with --spike or --stitch)")
    for flag in ("--spike", "--stitch", *AUGMENT_KNOBS):
        group = not_ported if flag in NOT_PORTED else knobs
        if flag in _FLAGS:
            group.add_argument(flag, action="store_true")
        else:
            kind = float if flag in _FLOATS else int if flag in _INTS else str
            group.add_argument(flag, default=None, type=kind)
    return parser
