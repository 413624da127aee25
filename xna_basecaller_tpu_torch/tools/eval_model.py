"""Copied from ``xna_basecaller_tpu/tools/eval_model.py``: the models
basecall on the card (``device``; ``"cpu"`` runs the plain versions of the
kernels), with the beam decoder where ``beam_width > 0``.

End-to-end model evaluation: basecall -> align -> UB analysis.

Python orchestration of the reference shell pipeline (reference:
eval_model.sh): basecall the eval reads (or reuse an existing FASTQ),
align to the library's refdb_short templates (built-in SW aligner in place
of the minimap2 binary), and run the UB analyzer producing the
results_summ CSV family.  Steps are idempotent — existing outputs are
reused (eval_model.sh:97,126,154).
"""

from __future__ import annotations

import os

from xna_basecaller_tpu_torch.data.writers import read_fastq
from xna_basecaller_tpu_torch.eval.analyze import analyze_paf
from xna_basecaller_tpu_torch.eval.ref_align import (
    align_fastq, read_paf, write_paf,
)
from xna_basecaller_tpu_torch.eval.xna_refs import EXP_REF_MAP, XnaRefs
from xna_basecaller_tpu_torch.utils.fileio import atomic_output

# default demux gates per library (reference eval_model.sh:64-68)
MAX_BC_DIST = {"POC": 5, "CPLX": 8}


def eval_model(exp: str, basecalls_dir: str, split: str = "test",
               reads_fastq: str | None = None, model_dir: str | None = None,
               reads_dir: str | None = None, read_ids: str | None = None,
               ubs: str = "XY", max_bc_dist: int | None = None,
               weights: int | None = None, n_proc: int = 0,
               targets_list_file: str | None = None,
               min_reads_count: int | None = None, debug: bool = False,
               save_confusion_matrix: bool = False,
               q_scores: bool = False, beam_width: int = 0,
               oracle_demux: bool = False, device: str = "cuda",
               log=print) -> dict:
    """Run the evaluation chain for one experiment/split; returns the
    summary dict and writes CSVs into ``basecalls_dir``."""
    os.makedirs(basecalls_dir, exist_ok=True)
    ref_name = EXP_REF_MAP.get(exp, exp)
    refs = XnaRefs(ref_name)

    # 1) basecalls (reference eval_model.sh:94-117)
    fastq_path = reads_fastq or os.path.join(
        basecalls_dir, f"reads-{exp}-{split}.fastq")
    if not os.path.exists(fastq_path):
        if model_dir is None or reads_dir is None:
            raise FileNotFoundError(
                f"{fastq_path} missing and no model/reads to produce it")
        log(f"> basecalling {reads_dir} -> {fastq_path}")
        from xna_basecaller_tpu_torch.data.fast5 import get_reads
        from xna_basecaller_tpu_torch.infer.basecall import run_basecaller
        from xna_basecaller_tpu_torch.utils.model_io import load_model
        model, cfg = load_model(model_dir, device=device, weights=weights)
        ids = None
        if read_ids:
            with open(read_ids) as fh:
                ids = {ln.strip().split()[0] for ln in fh if ln.strip()}
        reads = get_reads(reads_dir, read_ids=ids)
        with atomic_output(fastq_path) as fq:
            run_basecaller(
                model, reads, fq,
                chunksize=cfg.basecaller.chunksize,
                overlap=cfg.basecaller.overlap,
                batchsize=cfg.basecaller.batchsize,
                beam_width=beam_width)
    reads = read_fastq(fastq_path)
    if not reads:
        raise RuntimeError(f"no reads in {fastq_path}")

    # 2) alignment (reference eval_model.sh:119-148)
    paf_path = os.path.join(basecalls_dir, f"alignment-{exp}-{split}.paf")
    if os.path.exists(paf_path) and os.path.getsize(paf_path):
        records = read_paf(paf_path)
        log(f"> reusing {paf_path} ({len(records)} alignments)")
    else:
        log(f"> aligning {len(reads)} reads to {ref_name} templates")
        records = align_fastq(reads, refs.targets, n_proc=n_proc)
        write_paf(records, paf_path)  # atomic internally

    # 3) analysis (reference eval_model.sh:150-177)
    if max_bc_dist is None:
        max_bc_dist = MAX_BC_DIST.get(ref_name, 5)
    targets_list = None
    if targets_list_file:
        with open(targets_list_file) as fh:
            targets_list = [ln.strip() for ln in fh if ln.strip()]
    read_quals = None
    if q_scores:
        from xna_basecaller_tpu_torch.data.writers import read_fastq_quals
        read_quals = read_fastq_quals(fastq_path)
    prefix = f"results_summ-{exp}-{split}" + (
        "-oracle" if oracle_demux else "")
    summary = analyze_paf(
        exp, records, reads, max_bc_dist=max_bc_dist, ubs=ubs,
        out_dir=basecalls_dir, out_prefix=prefix,
        refs=refs, targets_list=targets_list,
        min_reads_count=min_reads_count, debug=debug,
        save_confusion_matrix=save_confusion_matrix,
        read_quals=read_quals, oracle_demux=oracle_demux, log=log)
    return summary


def load_members(workdirs, weights: str = "99", device: str = "cuda"):
    """The models of ``weights_{weights}.npz`` in each of ``workdirs``, all
    of the first one's ``config.toml`` (the members of an ensemble share
    one architecture), on ``device``; and that config."""
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.train import checkpoint as ckpt
    from xna_basecaller_tpu_torch.utils.device import resolve_device
    from xna_basecaller_tpu_torch.utils.weights import params_from_jax

    dev = resolve_device(device)
    cfg = config_lib.load(workdirs[0])
    models = []
    for w in workdirs:
        model = Model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(ckpt.load_flat(
            os.path.join(w, f"weights_{weights}.npz"))))
        models.append(model.to(dev))
    return models, cfg


def basecall_and_eval(workdir, reads, exp: str, split: str,
                      weights: str = "99", batchsize: int = 128,
                      ubs: str = "XY", out_dir: str | None = None,
                      chunksize: int = 3600, overlap: int = 500,
                      quantize: bool = False, beam_width: int = 0,
                      oracle_demux: bool = False, ub_bias: float = 0.0,
                      device: str = "cuda", log=print) -> dict:
    """Load ``weights_{weights}.npz`` from ``workdir``, basecall ``reads``
    into a FASTQ under ``out_dir`` (idempotent), and run :func:`eval_model`.

    The checkpoint-load -> basecall -> eval chain shared by the
    north-star and quick-run drivers (reference eval_model.sh:94-163).

    ``workdir`` may be a LIST of model dirs (same architecture): their
    checkpoints are decoded as a score-averaging ensemble
    (infer.basecall._forward) — an accuracy feature beyond the reference.
    """
    from xna_basecaller_tpu_torch.infer.basecall import run_basecaller

    workdirs = workdir if isinstance(workdir, (list, tuple)) else [workdir]
    models, _ = load_members(workdirs, weights, device)
    out_dir = out_dir or os.path.join(workdirs[0], f"basecalls-{split}")
    os.makedirs(out_dir, exist_ok=True)
    fq = os.path.join(out_dir, f"reads-{exp}-{split}.fastq")
    if not (os.path.exists(fq) and os.path.getsize(fq)):
        with atomic_output(fq) as fh:
            run_basecaller(models if len(models) > 1 else models[0],
                           iter(reads), fh, chunksize=chunksize,
                           overlap=overlap, batchsize=batchsize,
                           quantize=quantize, beam_width=beam_width,
                           ub_bias=ub_bias)
    return eval_model(exp, out_dir, split=split, reads_fastq=fq, ubs=ubs,
                      oracle_demux=oracle_demux, device=device, log=log)
