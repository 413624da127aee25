"""``xnacall duplex`` — template/complement duplex consensus calling.

Port of ``xna_basecaller_tpu/cli/duplex.py`` with its flags plus
``--device``: the basecalls (and, with ``--pair-decode``, the transition
posteriors) run on the card.  See ``infer/duplex.py`` for the algorithm.

Inputs: a model, a reads directory, and EITHER
  --pairs   a 2-column whitespace/TSV file of template/complement read ids
  --summary a sequencing summary from a previous aligned basecall run
            (``xnacall basecaller ... --reference ref.fa --summary s.tsv``),
            from which follow-on pairs are detected (reference
            duplex.py:184-214 semantics); read with the ``csv`` module
            (JAX reads it with pandas).
Duplex FASTQ goes to stdout.
"""

from __future__ import annotations

import argparse
import sys
from time import perf_counter


def main(args):
    from xna_basecaller_tpu_torch.data.fast5 import get_reads
    from xna_basecaller_tpu_torch.data.writers import write_fastq
    from xna_basecaller_tpu_torch.infer.duplex import (
        duplex_pairs, find_follow_on, read_summary,
    )
    from xna_basecaller_tpu_torch.utils.model_io import load_model

    if not args.pairs and not args.summary:
        sys.exit("duplex needs --pairs or --summary (see --help)")
    sys.stderr.write(f"> loading model {args.model_directory}\n")
    model, cfg = load_model(
        args.model_directory, device=args.device, batchsize=args.batchsize,
        chunksize=args.chunksize, overlap=args.overlap)

    if args.pairs:
        with open(args.pairs) as fh:
            pairs = [tuple(line.split()[:2]) for line in fh
                     if line.strip() and not line.startswith("#")]
    else:
        summary = read_summary(args.summary)
        if "alignment_genome_start" not in summary:
            sys.exit("--summary needs alignment columns: rerun the "
                     "basecaller with --reference and --summary")
        pairs = find_follow_on(summary, gap=args.gap,
                               distance=args.distance, cov=args.coverage,
                               min_len=args.min_length)
    sys.stderr.write(f"> {len(pairs)} duplex pairs\n")
    if not pairs:
        return

    t0 = perf_counter()
    n = 0
    reads = get_reads(
        args.reads_directory,
        read_ids={r for pair in pairs for r in pair},
        recursive=args.recursive)
    for dup in duplex_pairs(
            model, pairs, reads,
            chunksize=cfg.basecaller.chunksize,
            overlap=cfg.basecaller.overlap,
            batchsize=cfg.basecaller.batchsize,
            min_indel_q=args.min_indel_q,
            pair_decode=args.pair_decode):
        write_fastq(sys.stdout, dup.read_id, dup.sequence, dup.qstring,
                    tags=["dx:i:1", f"tp:Z:{dup.template_id}",
                          f"cp:Z:{dup.complement_id}"])
        n += 1
    sys.stderr.write(f"> {n} duplex reads in {perf_counter() - t0:.2f}s\n")


def argparser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        add_help=False)
    parser.add_argument("model_directory")
    parser.add_argument("reads_directory")
    parser.add_argument("--pairs", default=None,
                        help="2-column file of template/complement read ids")
    parser.add_argument("--summary", default=None,
                        help="sequencing summary TSV with alignment columns")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    parser.add_argument("--chunksize", type=int, default=None)
    parser.add_argument("--overlap", type=int, default=None)
    parser.add_argument("--batchsize", type=int, default=None)
    parser.add_argument("--recursive", action="store_true")
    parser.add_argument("--gap", type=float, default=5.0,
                        help="max seconds between template and complement")
    parser.add_argument("--distance", type=int, default=51,
                        help="max genome start/end distance between strands")
    parser.add_argument("--coverage", type=float, default=0.85)
    parser.add_argument("--min-length", type=int, default=100)
    parser.add_argument("--min-indel-q", type=int, default=15,
                        help="quality floor for single-strand indels")
    parser.add_argument("--pair-decode", action="store_true",
                        help="envelope-constrained exact pair Viterbi over "
                             "both strands' CRF transition posteriors "
                             "(reference duplex.py:257-297 algorithm); "
                             "falls back to the consensus merge per pair")
    return parser
