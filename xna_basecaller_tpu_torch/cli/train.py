"""``xnacall train`` — train a model on ctc-data, on the card.

Port of ``xna_basecaller_tpu/cli/train.py`` (reference surface:
ub-bonito/bonito/cli/train.py) with every flag of the JAX command plus
``--device``.  ``--spike`` and ``--stitch`` augment each batch (stitch
first, then spike) on ``--device`` when ``--ubs`` names the bases to
insert; without ``--ubs`` they change nothing, as in JAX (``need_bkps``).
The validation set is augmented the same way.  ``--profile DIR`` writes a
``torch.profiler`` trace of the fit (CPU and, on the card, CUDA
activities) to ``DIR/trace.json`` as a Chrome trace.  Without ``--config``
or ``--pretrained`` the flagship ``ModelConfig()`` is trained.

Data-parallel training over N GPUs (``parallel/distributed.py``)::

    python -m torch.distributed.run --nproc-per-node N \
        -m xna_basecaller_tpu_torch train <workdir> --directory <ctc-data>

Each rank joins the process group (NCCL; gloo with ``--device cpu``), runs
on ``cuda:LOCAL_RANK``, trains on its slice of every global batch of
``--batch`` rows, and rank 0 writes the workdir.  Without the launcher it
is one process, as before; JAX's command has no flag for this either (it
spans every device).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_augment(args):
    """The batch augmentation of ``args`` (stitch, then spike; each closure
    on ``args.device``), or None when no UB is to be inserted."""
    if not (args.ubs and (args.spike or args.stitch)):
        return None
    augments = []
    if args.stitch:
        from xna_basecaller_tpu_torch.augment.stitch import (
            make_stitch_augment,
        )
        augments.append(make_stitch_augment(
            args.xna_ctc_dir or args.directory, ubs=args.ubs,
            prop_ubs=args.ub_prop, cand_sample_size=args.cand_sample_size,
            noise_std=args.stitch_noise_std,
            noise_mode=args.stitch_noise_mode,
            weighted_pos_pick=args.weighted_pos_pick,
            permute_win_size=args.permute_win_size, pad=args.ub_pad,
            relax=args.stitch_relax, device=args.device))
    if args.spike:
        from xna_basecaller_tpu_torch.augment.spike import make_spike_augment
        augments.append(make_spike_augment(
            ubs=args.ubs, prop_ubs=args.synth_prop_ubs or args.ub_prop,
            noise_std=args.noise_std, std_dist=args.std_dist,
            fully_synth=args.fully_synth, pad=args.ub_pad,
            var_prop_ubs=args.var_prop_ubs, mix_ubs=not args.no_mix_ubs,
            device=args.device))

    def augment(chunks, targets, lengths, bkps, rng, _augs=tuple(augments)):
        # reference order: stitch first, then spike (data.py:70-79)
        for a in _augs:
            chunks, targets = a(chunks, targets, lengths, bkps, rng)
        return chunks, targets

    return augment


def main(args):
    from xna_basecaller_tpu_torch.parallel import distributed

    workdir = os.path.expanduser(args.training_directory)
    # every rank looks before joining: the group forms only when all have
    # looked, so no rank has made the directory yet
    exists = os.path.exists(workdir)
    distributed.initialize(device=args.device)
    try:
        fit(args, workdir, exists)
    finally:
        distributed.shutdown()


def fit(args, workdir: str, exists: bool):
    """``main`` once this process has its place: build the data, the model
    and the Trainer on this rank's device, and train."""
    import torch.distributed

    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.data.ctc_data import load_datasets
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.parallel.distributed import local_device
    from xna_basecaller_tpu_torch.parallel.mesh import make_mesh
    from xna_basecaller_tpu_torch.train.loop import Trainer
    from xna_basecaller_tpu_torch.utils.model_io import load_model

    if exists and not args.force:
        sys.stderr.write(
            f"[error] {workdir} exists, use -f to force continue\n")
        exit(1)
    args.device = str(local_device(args.device))
    mesh = make_mesh(args.device)
    if torch.distributed.is_initialized():
        sys.stderr.write(
            f"[{torch.distributed.get_backend()} process group: rank "
            f"{mesh.rank} of {mesh.world_size} on {mesh.device}]\n")
    os.makedirs(workdir, exist_ok=True)

    augment = build_augment(args)
    train_data, valid_data = load_datasets(
        args.directory, limit=args.chunks or None,
        load_bkps=augment is not None, augment=augment,
        valid_augment=augment, valid_limit=args.valid_chunks or None)

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

    if mesh.rank == 0:
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

    trainer = Trainer(
        model, train_data, valid_data,
        batchsize=args.batch, lr=args.lr, seed=args.seed,
        restore_optim=args.restore_optim,
        save_optim_every=args.save_optim_every,
        grad_accum_split=args.grad_accum_split,
        frozen_predicate=frozen_predicate, mesh=mesh,
    )
    from xna_basecaller_tpu_torch.utils.device import profiled

    # one trace, rank 0's
    with profiled(args.profile if mesh.rank == 0 else None, trainer.device,
                  lambda trace:
                  sys.stderr.write(f"[profile trace: {trace}]\n")):
        trainer.fit(workdir, epochs=args.epochs)


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
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the fit to "
                             "DIR/trace.json")
    # augmentation knobs (spike / stitch)
    parser.add_argument("--spike", action="store_true",
                        help="synthetic-signal UB spiking augmentation")
    parser.add_argument("--stitch", action="store_true",
                        help="real-signal splice augmentation")
    parser.add_argument("--ubs", default="", choices=["", "X", "Y", "XY", "N"],
                        help="unnatural bases to insert")
    parser.add_argument("--ub-prop", default=0.10, type=float)
    parser.add_argument("--var-prop-ubs", default=0.0, type=float,
                        help="vary UB proportion per chunk by +-this")
    parser.add_argument("--no-mix-ubs", action="store_true",
                        help="one UB letter per chunk instead of mixing")
    parser.add_argument("--ub-pad", default=5, type=int,
                        help="min base spacing between inserted UBs")
    parser.add_argument("--synth-prop-ubs", default=0.0, type=float,
                        help="separate spike proportion when combining "
                             "stitch + spike")
    parser.add_argument("--xna-ctc-dir", default=None,
                        help="real-XNA ctc-data for stitch slices")
    parser.add_argument("--cand-sample-size", default=5, type=int)
    parser.add_argument("--stitch-relax", action="store_true",
                        help="sparse-library donor fallback: redirect "
                             "empty exact-context stitch buckets to the "
                             "deepest-suffix occupied bucket (no-op on "
                             "fully-occupied donor tables)")
    parser.add_argument("--weighted-pos-pick", action="store_true",
                        help="k-mer-frequency-weighted insert positions")
    parser.add_argument("--permute-win-size", default=0, type=int,
                        help="permute stitched samples within windows")
    parser.add_argument("--stitch-noise-std", default=0.0, type=float)
    parser.add_argument("--stitch-noise-mode", default="single",
                        choices=["single", "single_variable", "block_add",
                                 "block_mult"])
    parser.add_argument("--noise-std", default=1.0, type=float)
    parser.add_argument("--std-dist", default="truncnorm_shift_1.5_0.5")
    parser.add_argument("--fully-synth", action="store_true")
    return parser
