"""``xnacall basecaller`` — basecall fast5 reads to FASTQ on the card.

Port of ``xna_basecaller_tpu/cli/basecaller.py`` for the CRF model and
FASTQ output.  The flags of the JAX command that this package does not
port yet are still recognised, and each is refused with an error instead
of being ignored, but only where it would change the result: the JAX
defaults (``--beam 0``, ``--superbatch 1``), ``--beamsize`` (JAX reads it
only for the CTC family, which this package does not load) and the
``--ctc-min-*`` filters without ``--save-ctc`` are accepted, as JAX does
nothing with them.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from time import perf_counter

# flag -> argparse dest of the options that are not ported yet
NOT_PORTED = {
    "--reference": "reference", "--sam": "sam", "--cram": "cram",
    "--bam": "bam", "--beam": "beam", "--qscores": "qscores",
    "--superbatch": "superbatch", "--ctc-min-coverage": "ctc_min_coverage",
    "--ctc-min-accuracy": "ctc_min_accuracy", "--save-ctc": "save_ctc",
    "--ub-only": "ub_only", "--mods-model": "mods_model",
    "--read-group": "read_group", "--profile": "profile",
}
# the values with which JAX does what this package does
INERT = {"beam": 0, "superbatch": 1, "ctc_min_coverage": 0.90,
         "ctc_min_accuracy": 0.95}


def _refused(args, dest: str) -> bool:
    """Whether the value of ``dest`` would make JAX do what this package
    does not; the --ctc-min-* filters act only with --save-ctc."""
    if dest.startswith("ctc_min") and args.save_ctc is None:
        return False
    return getattr(args, dest) not in (None, False, INERT.get(dest))


def main(args):
    for flag, dest in NOT_PORTED.items():
        if _refused(args, dest):
            sys.exit(f"xnacall basecaller: {flag} is not ported to "
                     "xna_basecaller_tpu_torch yet")
    if "," in args.model_directory:
        sys.exit("xnacall basecaller: checkpoint ensembles (comma-separated "
                 "model directories) are not ported to "
                 "xna_basecaller_tpu_torch yet")

    from xna_basecaller_tpu_torch.data.fast5 import get_reads
    from xna_basecaller_tpu_torch.data.writers import (
        mean_qscore_from_qstring, summary_row, write_fastq,
    )
    from xna_basecaller_tpu_torch.infer.basecall import basecall
    from xna_basecaller_tpu_torch.utils.model_io import load_model
    from xna_basecaller_tpu_torch.utils.pipeline import cancel_on_sigint

    sys.stderr.write(f"> loading model {args.model_directory}\n")
    model, cfg = load_model(
        args.model_directory, device=args.device,
        weights=args.weights or None, chunksize=args.chunksize,
        batchsize=args.batchsize, overlap=args.overlap)

    read_ids = None
    if args.read_ids:
        with open(args.read_ids) as fh:
            read_ids = {line.strip().split()[0]
                        for line in fh if line.strip()}
    cancel = cancel_on_sigint()
    reads = get_reads(args.reads_directory, read_ids=read_ids,
                      skip=args.skip, n_proc=8, recursive=args.recursive,
                      cancel=cancel)
    if args.max_reads:
        reads = itertools.islice(reads, args.max_reads)

    summary_fh = open(args.summary, "w") if args.summary else None
    header_written = False
    t0 = perf_counter()
    n_reads = n_samples = 0
    try:
        for read, attrs in basecall(
                model, reads, chunksize=cfg.basecaller.chunksize,
                overlap=cfg.basecaller.overlap,
                batchsize=cfg.basecaller.batchsize, reverse=args.revcomp,
                cancel=cancel, ub_bias=args.ub_bias,
                quantize=args.quantize or cfg.basecaller.quantize):
            n_reads += 1
            n_samples += len(read.signal)
            seq, qstring = attrs["sequence"], attrs["qstring"]
            if len(seq):
                write_fastq(sys.stdout, read.read_id, seq, qstring)
            if summary_fh is not None:
                row = summary_row(read, len(seq),
                                  mean_qscore_from_qstring(qstring))
                if not header_written:
                    summary_fh.write("\t".join(row) + "\n")
                    header_written = True
                summary_fh.write(
                    "\t".join(str(v) for v in row.values()) + "\n")
        duration = perf_counter() - t0
        sys.stderr.write(f"> completed reads: {n_reads}\n")
        sys.stderr.write(f"> duration: {duration:.2f}s\n")
        if duration > 0:
            sys.stderr.write(
                f"> samples per second {n_samples / duration:.1E}\n")
        sys.stderr.write("> done\n")
    finally:
        if summary_fh:
            summary_fh.close()


def argparser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    parser.add_argument("model_directory",
                        help="model directory (config.toml + weights_N.npz, "
                             "as the JAX package writes them)")
    parser.add_argument("reads_directory")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    parser.add_argument("--read-ids", default=None,
                        help="file of read ids to include")
    parser.add_argument("--skip", action="store_true",
                        help="treat --read-ids as an exclude list")
    parser.add_argument("--revcomp", action="store_true",
                        help="reverse-complement decoding (R strand)")
    parser.add_argument("--recursive", action="store_true")
    parser.add_argument("--beamsize", default=5, type=int,
                        help="CTC-family beam width: accepted for the JAX "
                             "command's sake, CRF models do not read it")
    parser.add_argument("--weights", default=0, type=int,
                        help="checkpoint epoch (0 = latest)")
    parser.add_argument("--chunksize", default=None, type=int)
    parser.add_argument("--overlap", default=None, type=int)
    parser.add_argument("--batchsize", default=None, type=int)
    parser.add_argument("--ub-bias", default=0.0, type=float,
                        help="decode-time score bias on UB-emitting "
                             "transitions")
    parser.add_argument("--quantize", action="store_true",
                        help="int8 upload, int8 LSTM and CRF head (also on "
                             "with quantize = true under [basecaller] in "
                             "the model's config.toml)")
    parser.add_argument("--max-reads", default=0, type=int)
    parser.add_argument("--summary", default=None,
                        help="write per-read summary tsv here")
    not_ported = parser.add_argument_group(
        "not ported yet (each is refused with an error)")
    for flag in ("--reference", "--cram", "--bam", "--save-ctc",
                 "--mods-model", "--read-group", "--profile"):
        not_ported.add_argument(flag, default=None)
    not_ported.add_argument("--beam", default=0, type=int,
                            help="only 0 (Viterbi)")
    not_ported.add_argument("--superbatch", default=1, type=int,
                            help="only 1")
    not_ported.add_argument("--ctc-min-coverage", default=0.90, type=float,
                            help="read with --save-ctc only")
    not_ported.add_argument("--ctc-min-accuracy", default=0.95, type=float,
                            help="read with --save-ctc only")
    for flag in ("--sam", "--qscores", "--ub-only"):
        not_ported.add_argument(flag, action="store_true")
    return parser
