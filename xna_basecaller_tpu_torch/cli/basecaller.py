"""``xnacall basecaller`` — basecall fast5 reads on the card to FASTQ,
SAM, BAM or CRAM, optionally aligning to a reference and writing new ctc
training data.

Port of ``xna_basecaller_tpu/cli/basecaller.py`` for the CRF model:
FASTQ, or with ``--reference`` SAM (``--sam``, ``--read-group``), the
summary's alignment columns and, with ``--save-ctc``, ctc-data made of the
reads' chunks that align (``--ctc-min-coverage``, ``--ctc-min-accuracy``,
``--ub-only``): phase B of the paper's chain, whose DTW breakpoints
``tools/dtw_segmentation.py`` writes.  ``--bam PATH`` (with
``--reference``) and ``--cram PATH`` write the calls in those formats as
well (``data/bam.py``, ``data/cram.py``); FASTQ goes to standard output
only when neither is set and ``--sam`` is off.  ``--superbatch G``
uploads G batches at once (``infer/basecall.py``).  ``--qscores`` writes
real per-base qualities (the FASTQ's and SAM's, and the summary's
``mean_qscore``), ``--beam W`` decodes with the path-collapsing beam
search, ``--profile DIR`` writes a ``torch.profiler`` trace of the run to
``DIR/trace.json``.  ``--mods-model``, which this package does not port
yet, is still recognised and refused with an error instead of being
ignored; ``--beamsize`` (JAX reads it only for the CTC family, which this
package does not load) is accepted, as JAX does nothing with it.
Comma-separated model directories basecall as a checkpoint ensemble, as
in JAX.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
from time import perf_counter

# flag -> argparse dest of the options that are not ported yet
NOT_PORTED = {"--mods-model": "mods_model"}


def main(args):
    for flag, dest in NOT_PORTED.items():
        if getattr(args, dest) is not None:
            sys.exit(f"xnacall basecaller: {flag} is not ported to "
                     "xna_basecaller_tpu_torch yet")

    from xna_basecaller_tpu_torch.data.fast5 import get_reads
    from xna_basecaller_tpu_torch.utils.model_io import load_model
    from xna_basecaller_tpu_torch.utils.pipeline import cancel_on_sigint

    sys.stderr.write(f"> loading model {args.model_directory}\n")
    # comma-separated dirs decode as a score-averaging checkpoint
    # ensemble (infer.basecall._forward)
    model_dirs = args.model_directory.split(",")
    models = []
    for d in model_dirs:
        model, cfg_d = load_model(
            d, device=args.device, weights=args.weights or None,
            chunksize=args.chunksize, batchsize=args.batchsize,
            overlap=args.overlap)
        if not models:
            cfg = cfg_d
        elif (cfg_d.alphabet != cfg.alphabet
              or cfg_d.state_len != cfg.state_len
              or cfg_d.encoder != cfg.encoder):
            sys.exit(f"xnacall basecaller: ensemble member {d} is "
                     f"architecturally incompatible with {model_dirs[0]} "
                     "(alphabet/state_len/encoder must match)")
        models.append(model)

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
    call_reads(args, models if len(models) > 1 else models[0], cfg, reads,
               cancel=cancel)


def align(seq: str, targets: dict[str, str]):
    """The read's best alignment to the templates, as a PAF record dict,
    and the aligned span of its template; (None, None) if none scores."""
    from xna_basecaller_tpu_torch.eval.ref_align import align_read

    rec = align_read("q", seq, targets)
    if rec is None:
        return None, None
    return (rec.as_dict(),
            targets[rec.target_id][rec.target_start:rec.target_end])


def call_reads(args, model, cfg, reads, out=None, cancel=None) -> dict:
    """What ``main`` does once the model (or the list of an ensemble's
    members) is loaded and the reads are open:
    basecall ``reads`` (objects with ``read_id`` and ``signal``; with
    ``--save-ctc`` cut into chunk-reads of the model's chunk size first),
    align each call to ``--reference``'s templates, and write FASTQ or
    SAM to ``out`` (standard output by default), the BAM and CRAM files,
    the summary and the ctc-data, as the JAX command does.  Returns
    {"reads", "samples", "seconds"}: the reads (chunk-reads) called, their
    samples, and the host-clock time of the calls, alignment and writing
    (the ctc-data's save excluded)."""
    from xna_basecaller_tpu_torch.data.fast5 import read_chunks
    from xna_basecaller_tpu_torch.data.writers import (
        CtcDataWriter, SamWriter, mean_qscore_from_qstring, summary_row,
        write_fastq,
    )
    from xna_basecaller_tpu_torch.eval.xna_refs import read_fasta
    from xna_basecaller_tpu_torch.infer.basecall import basecall
    from xna_basecaller_tpu_torch.utils.device import profiled

    out = sys.stdout if out is None else out
    targets = None
    if args.reference:
        sys.stderr.write("> loading reference\n")
        targets = read_fasta(args.reference)
    if args.save_ctc and not args.reference:
        sys.stderr.write(
            "> a reference is needed to output ctc training data\n")
        sys.exit(1)

    chunksize = cfg.basecaller.chunksize
    ctc_writer = None
    if args.save_ctc:
        reads = (chunk for read in reads
                 for chunk in read_chunks(read, chunksize=chunksize,
                                          overlap=cfg.basecaller.overlap))
        ctc_writer = CtcDataWriter(
            args.save_ctc, min_coverage=args.ctc_min_coverage,
            min_accuracy=args.ctc_min_accuracy, ub_only=args.ub_only,
            log=lambda *a: sys.stderr.write(" ".join(map(str, a)) + "\n"))
    # read group <model_name> (reference io.py:86-111 uses
    # <run_id>_<model>; run_id is per-read here, so the stable part): the
    # first member's directory for an ensemble
    read_group = args.read_group or os.path.basename(
        os.path.normpath(args.model_directory.split(",")[0]))
    sam = None
    if args.sam and targets is not None:
        sam = SamWriter(out, targets, read_group=read_group)
    bam = cram = None
    if args.bam is not None:
        if targets is None:
            sys.exit("--bam requires --reference")
        from xna_basecaller_tpu_torch.data.bam import BamWriter
        bam = BamWriter(args.bam, targets, read_group=read_group)
    if args.cram is not None:
        from xna_basecaller_tpu_torch.data.cram import CramWriter
        cram = CramWriter(args.cram, targets, read_group=read_group)

    summary_fh = open(args.summary, "w") if args.summary else None
    header_written = False
    first = model[0] if isinstance(model, (list, tuple)) else model
    t0 = perf_counter()
    n_reads = n_samples = 0
    try:
        with profiled(args.profile, next(first.parameters()).device,
                      lambda trace: sys.stderr.write(
                          f"> profile trace: {trace}\n")):
            for read, attrs in basecall(
                    model, reads, chunksize=chunksize,
                    overlap=cfg.basecaller.overlap,
                    batchsize=cfg.basecaller.batchsize, reverse=args.revcomp,
                    qscores=args.qscores, cancel=cancel,
                    quantize=args.quantize or cfg.basecaller.quantize,
                    beam_width=args.beam, superbatch=args.superbatch,
                    ub_bias=args.ub_bias):
                n_reads += 1
                n_samples += len(read.signal)
                seq, qstring = attrs["sequence"], attrs["qstring"]
                mapping, refseq = (None, None)
                if targets is not None and len(seq):
                    mapping, refseq = align(seq, targets)
                if ctc_writer is not None:
                    ctc_writer.add(read.signal[:chunksize], seq, mapping,
                                   refseq=refseq)
                if len(seq):
                    for w in (bam, cram, sam):
                        if w is not None:
                            w.write(read.read_id, seq, qstring, mapping)
                    if sam is bam is cram is None:
                        write_fastq(out, read.read_id, seq, qstring)
                if summary_fh is not None:
                    row = summary_row(read, len(seq),
                                      mean_qscore_from_qstring(qstring),
                                      alignment=mapping)
                    if not header_written:
                        summary_fh.write("\t".join(row) + "\n")
                        header_written = True
                    summary_fh.write(
                        "\t".join(str(v) for v in row.values()) + "\n")
            duration = perf_counter() - t0
        for w in (bam, cram):
            if w is not None:
                w.close()
        if ctc_writer is not None:
            ctc_writer.save()
        sys.stderr.write(f"> completed reads: {n_reads}\n")
        sys.stderr.write(f"> duration: {duration:.2f}s\n")
        if duration > 0:
            sys.stderr.write(
                f"> samples per second {n_samples / duration:.1E}\n")
        sys.stderr.write("> done\n")
    finally:
        if summary_fh:
            summary_fh.close()
    return {"reads": n_reads, "samples": n_samples, "seconds": duration}


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
    parser.add_argument("--beam", default=0, type=int, metavar="W",
                        help="CRF path-collapsing beam width (0 = Viterbi; "
                             "1 to 256 on the card)")
    parser.add_argument("--qscores", action="store_true",
                        help="emit real per-base qualities from posterior "
                             "confidences (reference UB path uses dummies)")
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
    parser.add_argument("--reference", default=None,
                        help="reference fasta for alignment")
    parser.add_argument("--sam", action="store_true",
                        help="emit SAM instead of FASTQ (needs --reference)")
    parser.add_argument("--read-group", default=None,
                        help="@RG id for SAM/BAM output (default: model "
                             "directory name)")
    parser.add_argument("--bam", default=None, metavar="PATH",
                        help="also write binary BAM to PATH "
                             "(needs --reference)")
    parser.add_argument("--cram", default=None, metavar="PATH",
                        help="write basecalls as a CRAM 3.0 container "
                             "(unmapped records)")
    parser.add_argument("--superbatch", default=1, type=int, metavar="G",
                        help="upload G batches at once; they run one after "
                             "another.  Runs as 1 (a warning) with "
                             "--qscores or --beam")
    parser.add_argument("--save-ctc", default=None,
                        help="directory to write ctc training data")
    parser.add_argument("--ctc-min-coverage", default=0.90, type=float)
    parser.add_argument("--ctc-min-accuracy", default=0.95, type=float)
    parser.add_argument("--ub-only", action="store_true",
                        help="keep only chunks whose reference contains a UB")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace (CPU and CUDA "
                             "activity) of the run to DIR/trace.json")
    not_ported = parser.add_argument_group(
        "not ported yet (refused with an error)")
    not_ported.add_argument("--mods-model", default=None)
    return parser
