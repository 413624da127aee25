"""Copied from ``scripts/spliced_northstar.py`` (the north-star script),
on the card: the trainings and basecalls of every phase run on
``--device`` (the card unless ``cpu``; ``--cpu`` is ``--device cpu``).
The phases, their gates (coverage 0.9, ``--ctc-min-acc`` 0.85), their
function names and ``northstar_summary.json``'s keys are JAX's; each
phase also logs its wall time on a line of its own.

    python -m xna_basecaller_tpu_torch.tools.spliced_northstar --out DIR

North-star config #5 end-to-end: bootstrapped SPLICED (stitch) training.

The complete reference train_and_eval.sh semantics (train_and_eval.sh:
102-162 + run_ub_validation.sh:65-75) driven as one resumable chain:

  A) bootstrap: spike-XY-train a base model on simulated DNA ctc-data
  B) bootstrap data (the reference's --save-ctc loop, io.py:448-579):
     simulate library reads, basecall them with (A), align to the refdb,
     and keep accurate chunks as NEW ctc-data — one XNA set (stitch slice
     source, --ub-only) and one DNA set (training base); then DTW
     segmentation for breakpoints on both (src/tools/dtw_segmentation.py)
  C) spliced training: pretrained (A), freeze-bottom/unfreeze-top-3,
     stitch ubs=XY ub_prop 0.09 (BASELINE config #5 knobs)
  D) per-epoch UB validation on held-out-regime reads, best-epoch
     selection (weights_99 symlink), test eval — results_summ CSV chain

Evaluation reads use the HELD-OUT signal regime (data/simulate.py REGIMES:
different dwell distribution + noise model than any training/augmentation
signal), so the reported UB accuracy is not circular with the simulator.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
from glob import glob

import numpy as np


def log(*a):
    print(*a, flush=True)


def phase_a_bootstrap(args, cfg_dir):
    from xna_basecaller_tpu_torch.augment.spike import make_spike_augment
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.data.ctc_data import ChunkDataset
    from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.train.loop import Trainer

    workdir = os.path.join(args.out, "bootstrap_model")
    # done marker = config.toml: it is written only after fit() completes,
    # while training.csv exists from epoch 1 (a run killed mid-training
    # must re-enter fit(), which resumes from the latest saved epoch)
    if os.path.exists(os.path.join(workdir, "config.toml")):
        log("> [A] bootstrap model exists, skipping")
        return workdir
    t0 = time.time()
    log(f"> [A] simulating {args.boot_chunks} DNA chunks...")
    chunks, refs, lens, bkps = simulate_ctc_dataset(
        args.boot_chunks, chunk_len=3600, target_len=400, seed=11)
    augment = make_spike_augment(ubs="XY", prop_ubs=0.10, noise_std=1.0,
                                 device=args.device)
    n_val = max(args.batch, args.boot_chunks // 32)
    train = ChunkDataset(chunks[:-n_val], refs[:-n_val], lens[:-n_val],
                         bkps[:-n_val], augment=augment)
    valid = ChunkDataset(chunks[-n_val:], refs[-n_val:], lens[-n_val:],
                         bkps[-n_val:], augment=augment,
                         epoch_reset_seed=True)
    cfg = config_lib.load(cfg_dir)
    model = Model(cfg, device=args.device)
    trainer = Trainer(model, train, valid, batchsize=args.batch,
                      lr=1e-3, warmup_steps=300, log=log)
    trainer.fit(workdir, epochs=args.boot_epochs)
    config_lib.save(cfg, workdir)
    log(f"> [A] bootstrap trained in {time.time() - t0:.0f}s")
    return workdir


def phase_b_bootstrap_data(args, boot_dir):
    from xna_basecaller_tpu_torch.data.simulate import (
        SimReadObj, sim_library_reads,
    )
    from xna_basecaller_tpu_torch.data.writers import CtcDataWriter
    from xna_basecaller_tpu_torch.eval.construct_align import from_refs
    from xna_basecaller_tpu_torch.eval.xna_refs import XnaRefs
    from xna_basecaller_tpu_torch.infer.basecall import basecall
    from xna_basecaller_tpu_torch.tools.dtw_segmentation import (
        dtw_segmentation,
    )
    from xna_basecaller_tpu_torch.utils.model_io import load_model
    from xna_basecaller_tpu_torch.utils.pipeline import ordered_thread_map

    refs = XnaRefs(args.exp)
    out = {}
    model, cfg = load_model(boot_dir, device=args.device)
    for kind, with_ubs, n_reads, ub_only in (
            ("xna", True, args.xna_reads, True),
            ("dna", False, args.dna_reads, False)):
        ctc_dir = os.path.join(args.out, f"ctc_{kind}")
        out[kind] = ctc_dir
        if os.path.exists(os.path.join(ctc_dir, "breakpoints.npy")):
            log(f"> [B] {kind} ctc-data exists, skipping")
            continue

        # shards bound the work lost to a failure mid-phase (completed
        # shards are skipped on a rerun)
        n_shards = max(1, round(n_reads / args.shard_reads))
        base_seed = 100 if kind == "xna" else 200
        shard_dirs = []
        aligner = None
        for si in range(n_shards):
            sdir = (ctc_dir if n_shards == 1
                    else os.path.join(args.out, f"ctc_{kind}_s{si}"))
            shard_dirs.append(sdir)
            if os.path.exists(os.path.join(sdir, "chunks.npy")):
                log(f"> [B] {kind} shard {si} exists, skipping")
                continue
            t0 = time.time()
            rng = np.random.default_rng(base_seed + 1000 * si)
            shard_n = n_reads // n_shards + (si < n_reads % n_shards)

            def chunk_reads():
                for read in sim_library_reads(
                        refs, rng, shard_n, with_ubs, "default",
                        read_len_chunks=args.read_chunks,
                        jitter=args.jitter):
                    sig = read.signal
                    for j in range(len(sig) // 3600):
                        yield SimReadObj(
                            read_id=f"{read.read_id}:{j}",
                            signal=sig[j * 3600:(j + 1) * 3600])

            # reference coverage gate (io.py:505): >=90% of the basecall
            # must align, which with full-construct fragment reads also
            # means the stored target covers the whole chunk signal
            min_acc = (args.dna_min_acc if kind == "dna"
                       and args.dna_min_acc is not None
                       else args.ctc_min_acc)
            writer = CtcDataWriter(sdir, min_coverage=0.9,
                                   min_accuracy=min_acc,
                                   ub_only=ub_only, log=log)
            # two-stage construct aligner: canonical-backbone SW + insert
            # demux (eval/construct_align.py) — the minimap2-vs-refdb
            # equivalent of the reference's --save-ctc path
            if aligner is None:
                aligner = from_refs(refs, with_ubs=with_ubs)

            def _align(item):
                read, attrs = item
                seq = attrs["sequence"]
                rec = aligner.align(read.read_id, seq) if seq else None
                return read, seq, rec

            n_in = 0
            # native SW/levenshtein release the GIL -> thread map scales
            try:
                for read, seq, rec in ordered_thread_map(
                        _align,
                        basecall(model, chunk_reads(),
                                 chunksize=3600, overlap=500,
                                 batchsize=args.batch),
                        n_workers=args.n_proc, maxsize=8):
                    n_in += 1
                    if not seq:
                        writer.add(read.signal, seq, None)
                        continue
                    mapping = rec.as_dict() if rec else None
                    refseq = (aligner.refseq(rec) if rec is not None
                              else None)
                    writer.add(read.signal, seq, mapping, refseq=refseq)
            except Exception:
                # a shard's failure shows in the chain's log, then the
                # phase fails (completed shards are kept for a rerun)
                import traceback
                log(f"> [B] {kind} shard {si} FAILED after {n_in} reads "
                    f"({time.time() - t0:.0f}s):\n{traceback.format_exc()}")
                raise
            n_kept = writer.save()
            log(f"> [B] {kind} shard {si}: {n_kept}/{n_in} chunks kept "
                f"({time.time() - t0:.0f}s); stats={writer.stats}")
        if n_shards > 1:
            from xna_basecaller_tpu_torch.data.ctc_data import merge_ctc_dirs
            n_tot = merge_ctc_dirs(ctc_dir, *shard_dirs, load_bkps=False)
            log(f"> [B] {kind}: merged {n_shards} shards -> {n_tot} chunks")
        if not os.path.exists(os.path.join(ctc_dir, "chunks.npy")) or \
                not len(np.load(os.path.join(ctc_dir, "chunks.npy"),
                                mmap_mode="r")):
            raise RuntimeError(f"bootstrap produced no {kind} ctc data")
        dtw_segmentation(ctc_dir, n_proc=args.n_proc, log=log)
    return out["xna"], out["dna"]


SWA_EPOCH = 90  # pseudo-epoch id for the tail weight average (99 = best)


def phase_c_spliced_train(args, boot_dir, dna_dir, xna_dir, seed: int,
                          workdir: str):
    from xna_basecaller_tpu_torch.cli.train import argparser
    from xna_basecaller_tpu_torch.cli.train import main as train_main

    if os.path.exists(os.path.join(
            workdir, f"weights_{args.epochs}.npz")):
        log(f"> [C] spliced model (seed {seed}) fully trained, skipping")
    else:
        argv = [workdir, "--directory", dna_dir, "--xna-ctc-dir", xna_dir,
                "--pretrained", boot_dir, "--stitch", "--ubs", args.ubs,
                "--ub-prop", str(args.ub_prop),
                "--freeze-bottom", "--unfreeze-top", str(args.unfreeze_top),
                "--epochs", str(args.epochs), "--batch", str(args.batch),
                "--lr", str(args.lr), "--seed", str(seed), "-f",
                "--device", args.device]
        if getattr(args, "stitch_relax", False):
            argv.append("--stitch-relax")
        log(f"> [C] spliced training: {' '.join(argv)}")
        train_main(argparser().parse_args(argv))
    if args.swa:
        _write_swa_checkpoint(args, workdir)
    return workdir


def _mean_checkpoint(paths: list, out: str) -> None:
    """weights_N.npz files -> their element-wise mean, saved to ``out``
    (``np.mean`` over the stacked arrays, as JAX's ``jax.tree.map`` of it)."""
    from xna_basecaller_tpu_torch.train import checkpoint as ckpt

    flats = [ckpt.load_flat(p) for p in paths]
    ckpt.save_flat({k: np.mean(np.stack([f[k] for f in flats]), axis=0)
                    for k in flats[0]}, out)


def _write_swa_checkpoint(args, workdir):
    """Tail weight averaging (SWA): mean of the last half of the epoch
    checkpoints, saved as weights_90.npz so phase D validates it as just
    another candidate — selection stays honest (val err_only_ub picks it
    only if it actually wins).  Under the warmup-cosine schedule the tail
    epochs sit at low LR, the regime where averaging flattens the noise
    of per-epoch SGD endpoints."""
    from xna_basecaller_tpu_torch.train import checkpoint as ckpt

    if args.epochs >= SWA_EPOCH:
        log(f"> [C] SWA skipped: --epochs {args.epochs} collides with "
            f"the SWA pseudo-epoch id {SWA_EPOCH}")
        return
    out = os.path.join(workdir, f"weights_{SWA_EPOCH}.npz")
    if os.path.exists(out):
        log("> [C] SWA checkpoint exists, skipping")
        return
    tail = list(range(args.epochs // 2 + 1, args.epochs + 1))
    paths = [os.path.join(workdir, f"weights_{e}.npz") for e in tail]
    paths = [p for p in paths if os.path.exists(p)]
    if len(paths) < 2:
        log("> [C] SWA: <2 tail checkpoints, skipping")
        return
    _mean_checkpoint(paths, out)
    ckpt.mark_reserved(workdir, SWA_EPOCH)
    log(f"> [C] SWA checkpoint: mean of epochs {tail} -> weights_{SWA_EPOCH}")


def _write_soup_dir(soup_dir: str, member_dirs: list) -> None:
    """Materialise a model dir whose weights_99 is the MEAN of the
    members' weights_99 (model soup; config copied from the first
    member).  Idempotent per soup_dir (the dir is membership-keyed)."""
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.train import checkpoint as ckpt

    out = os.path.join(soup_dir, "weights_99.npz")
    if os.path.exists(out):
        return
    os.makedirs(soup_dir, exist_ok=True)
    config_lib.save(config_lib.load(member_dirs[0]), soup_dir)
    _mean_checkpoint([os.path.join(d, "weights_99.npz")
                      for d in member_dirs], out)
    ckpt.mark_reserved(soup_dir, 99)


def _sim_heldout(refs, g, n):
    from xna_basecaller_tpu_torch.data.simulate import sim_library_reads
    return sim_library_reads(refs, g, n, True, "heldout",
                             read_len_chunks=1)


def make_eval_reads(args, refs):
    """Fixed eval read sets, shared across epochs AND seeds (identical
    val reads make the cross-seed selection comparable)."""
    from xna_basecaller_tpu_torch.data.simulate import sim_library_reads

    rng = np.random.default_rng(777)
    val_reads = list(_sim_heldout(refs, rng, args.val_reads))
    test_reads = list(_sim_heldout(refs, rng, args.test_reads))
    # matched in-distribution test set for the circularity comparison;
    # secondary evals (in-dist, POC) may run smaller than the north-star
    # held-out eval — only the latter's CI gates the accuracy target
    n2 = args.secondary_test_reads or args.test_reads
    rng2 = np.random.default_rng(778)
    test_reads_ind = list(sim_library_reads(
        refs, rng2, n2, True, "default", read_len_chunks=1))
    return val_reads, test_reads, test_reads_ind


def phase_d_validate(args, workdir, val_reads):
    """Per-epoch validation of one spliced workdir; returns
    (best_epoch, best val err_only_ub)."""
    from xna_basecaller_tpu_torch.infer.basecall import run_basecaller
    from xna_basecaller_tpu_torch.tools.consolidate_ub_validation import (
        collect_epoch_summaries,
    )
    from xna_basecaller_tpu_torch.tools.eval_model import load_members
    from xna_basecaller_tpu_torch.tools.train_and_eval import (
        run_ub_validation,
    )
    from xna_basecaller_tpu_torch.utils.fileio import atomic_output

    epochs = sorted({
        int(m.group(1)) for f in glob(os.path.join(workdir, "weights_*.npz"))
        if (m := re.search(r"weights_(\d+)\.npz$", f))
        and not os.path.islink(f) and not f.endswith("weights_99.npz")})
    # long trainings: validate a subset of checkpoints — always keep the
    # last REAL training epoch (SWA's pseudo-epoch 90 must not shadow
    # it) and always keep the SWA candidate itself
    real = [e for e in epochs if e != SWA_EPOCH]
    last = real[-1] if real else 0
    epochs = [e for e in epochs
              if e == SWA_EPOCH
              or (e >= args.val_from
                  and (e % args.val_every == 0 or e == last))]
    fastq_per_epoch = {}
    for epoch in epochs:
        out_dir = os.path.join(workdir, f"basecalls-weights_{epoch}")
        os.makedirs(out_dir, exist_ok=True)
        fq = os.path.join(out_dir, f"reads-{args.exp}-val.fastq")
        fastq_per_epoch[epoch] = fq
        if os.path.exists(fq) and os.path.getsize(fq):
            continue
        (model,), _ = load_members([workdir], str(epoch), args.device)
        t0 = time.time()
        with atomic_output(fq) as fh:
            stats = run_basecaller(model, iter(val_reads), fh,
                                   chunksize=3600, overlap=500,
                                   batchsize=args.batch)
        log(f"> [D] epoch {epoch}: basecalled val in "
            f"{time.time() - t0:.0f}s ({stats['samples_per_s']:.2E} sps)")
    best = run_ub_validation(workdir, args.exp, ubs=args.ubs,
                             fastq_per_epoch=fastq_per_epoch,
                             device=args.device, log=log)
    best_err = float("inf")
    if best is not None:
        df = collect_epoch_summaries(workdir, exp=args.exp, split="val")
        best_err = float(df.loc[best, "err_only_ub"])
    log(f"> [D] best epoch: {best} (val err_only_ub {best_err:.2f})")
    return best, best_err


def phase_e_test(args, workdir, test_reads, test_reads_ind,
                 out_base: str | None = None):
    """Test eval of the winning workdir's best (weights_99) checkpoint:
    held-out + in-distribution (+ POC cross-library for CPLX).
    ``workdir`` may be a list of dirs (seed ensemble); ``out_base`` then
    roots the basecall output dirs."""
    from xna_basecaller_tpu_torch.eval.xna_refs import XnaRefs
    from xna_basecaller_tpu_torch.tools.eval_model import basecall_and_eval

    if out_base is None:
        out_base = workdir if isinstance(workdir, str) else workdir[0]
    results = {}
    evals = [(args.exp, "test", test_reads),
             (args.exp, "test-ind", test_reads_ind)]
    if args.exp == "CPLX":
        # reference config #5 evaluates the CPLX-trained model on the POC
        # library too (train_and_eval.sh -E POC, README.md:108)
        poc_refs = XnaRefs("POC")
        rng3 = np.random.default_rng(779)
        poc_reads = list(_sim_heldout(
            poc_refs, rng3, args.secondary_test_reads or args.test_reads))
        evals.append(("POC", "test", poc_reads))
    for exp, tag, reads in evals:
        key = tag if exp == args.exp else f"{exp}-{tag}"
        out_dir = os.path.join(out_base, f"basecalls-{key}")
        results[key] = basecall_and_eval(
            workdir, reads, exp, tag, weights="99",
            batchsize=args.batch, ubs=args.ubs,
            out_dir=out_dir, device=args.device, log=log)
        # oracle-demux decomposition: reuses the fastq + paf just written
        # — pure re-analysis, no extra basecalling.  Splits ub_acc losses
        # into demux-misassignment vs UB-calling error and reports the
        # real demux's assignment accuracy.
        results[key + "_oracle"] = basecall_and_eval(
            workdir, reads, exp, tag, weights="99",
            batchsize=args.batch, ubs=args.ubs,
            out_dir=out_dir, oracle_demux=True, device=args.device,
            log=log)
    return results


def argparser():
    p = argparse.ArgumentParser()
    p.add_argument("--exp", default="CPLX", choices=["POC", "CPLX"])
    p.add_argument("--ubs", default="XY", choices=["X", "Y", "XY"],
                   help="which unnatural bases to stitch in training and "
                        "score in eval (the reference's per-ubs rows, "
                        "README.md:139-143)")
    p.add_argument("--stitch-relax", action="store_true",
                   help="sparse-library stitch donor fallback")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "spliced_northstar"))
    p.add_argument("--features", type=int, default=768)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--epochs", type=int, default=8,
                   help="spliced-training epochs")
    p.add_argument("--ub-prop", type=float, default=0.09,
                   help="stitch UB insert proportion (BASELINE config #5)")
    p.add_argument("--unfreeze-top", type=int, default=3)
    p.add_argument("--boot-epochs", type=int, default=10)
    p.add_argument("--boot-chunks", type=int, default=12288)
    p.add_argument("--xna-reads", type=int, default=6000)
    p.add_argument("--dna-reads", type=int, default=5000)
    p.add_argument("--read-chunks", type=int, default=2,
                   help="device chunks per simulated bootstrap read")
    p.add_argument("--shard-reads", type=int, default=12000,
                   help="bootstrap-data shard size (resume granularity)")
    p.add_argument("--ctc-min-acc", type=float, default=0.85)
    p.add_argument("--dna-min-acc", type=float, default=None,
                   help="separate (stricter) accuracy gate for the DNA "
                        "training base")
    p.add_argument("--jitter", action="store_true",
                   help="domain-randomise the bootstrap-data signal regime")
    p.add_argument("--seeds", default="25",
                   help="comma-separated training seeds; phase C trains "
                        "one spliced model per seed on the SAME data and "
                        "phase D selects the winner by val err_only_ub")
    p.add_argument("--no-ensemble", action="store_true",
                   help="skip the cross-seed score-averaging ensemble "
                        "candidate")
    p.add_argument("--swa", action="store_true",
                   help="add a tail-weight-average checkpoint per seed as "
                        "an extra validation candidate")
    p.add_argument("--val-reads", type=int, default=300)
    p.add_argument("--val-every", type=int, default=1,
                   help="validate every k-th epoch checkpoint (plus the last)")
    p.add_argument("--val-from", type=int, default=0,
                   help="skip per-epoch validation below this epoch")
    p.add_argument("--test-reads", type=int, default=400)
    p.add_argument("--secondary-test-reads", type=int, default=None,
                   help="read count for the secondary test evals "
                        "(in-distribution + POC cross-library); default "
                        "= --test-reads")
    p.add_argument("--n-proc", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device of the trainings and basecalls")
    p.add_argument("--cpu", action="store_true",
                   help="--device cpu (micro smoke runs)")
    return p


def main(argv=None) -> dict:
    args = argparser().parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    os.makedirs(args.out, exist_ok=True)

    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.core.config import (
        EncoderConfig, ModelConfig,
    )
    from xna_basecaller_tpu_torch.eval.xna_refs import XnaRefs
    from xna_basecaller_tpu_torch.tools.eval_model import basecall_and_eval

    cfg_dir = os.path.join(args.out, "base_config")
    os.makedirs(cfg_dir, exist_ok=True)
    config_lib.save(ModelConfig(encoder=EncoderConfig(
        features=args.features, num_rnn_layers=args.layers)), cfg_dir)

    t0 = time.time()
    t = time.time()
    boot_dir = phase_a_bootstrap(args, cfg_dir)
    log(f"> [A] wall time {time.time() - t:.1f} s")
    t = time.time()
    xna_dir, dna_dir = phase_b_bootstrap_data(args, boot_dir)
    log(f"> [B] wall time {time.time() - t:.1f} s")

    val_reads, test_reads, test_reads_ind = make_eval_reads(
        args, XnaRefs(args.exp))

    seeds = [int(s) for s in str(args.seeds).split(",") if s.strip()]
    candidates = []  # (val err_only_ub, seed, workdir, best_epoch)
    for seed in seeds:
        workdir = (os.path.join(args.out, "spliced_model") if len(seeds) == 1
                   else os.path.join(args.out, f"spliced_model_s{seed}"))
        t = time.time()
        phase_c_spliced_train(args, boot_dir, dna_dir, xna_dir, seed,
                              workdir)
        log(f"> [C] seed {seed}: wall time {time.time() - t:.1f} s")
        t = time.time()
        best, best_err = phase_d_validate(args, workdir, val_reads)
        log(f"> [D] seed {seed}: wall time {time.time() - t:.1f} s")
        candidates.append((best_err, seed, workdir, best))
        log(f"> seed {seed}: best epoch {best} "
            f"(val err_only_ub {best_err:.2f})")
    # ensemble candidate: score-averaged decode over every seed's best
    # checkpoint, judged on the SAME val reads as the single seeds
    ens_dirs = [w for e, s, w, b in candidates
                if np.isfinite(e) and b is not None]
    ens_err = float("inf")
    # key the cache dir by ensemble membership AND each member's
    # resolved best checkpoint, so a resumed run with different seeds
    # or a moved weights_99 symlink can never reuse a stale decode
    ens_tag = "-".join(
        f"s{s}e{b}" for e, s, w, b in sorted(candidates, key=lambda c: c[1])
        if np.isfinite(e) and b is not None)
    ens_base = os.path.join(args.out, f"ensemble_{ens_tag}")
    if len(ens_dirs) > 1 and not args.no_ensemble:
        t = time.time()
        summ = basecall_and_eval(
            ens_dirs, val_reads, args.exp, "val", weights="99",
            batchsize=args.batch, ubs=args.ubs,
            out_dir=os.path.join(ens_base, "basecalls-val"),
            device=args.device, log=log)
        ens_err = float(summ.get("err_only_ub", float("inf")))
        log(f"> ensemble({len(ens_dirs)} seeds): "
            f"val err_only_ub {ens_err:.2f}")
        log(f"> [D] ensemble: wall time {time.time() - t:.1f} s")

    # model-soup candidate: cross-seed WEIGHT average of the best
    # checkpoints.  Every seed fine-tunes the same bootstrap init with
    # the bottom frozen, so the endpoints share a loss basin and their
    # average is a single model (zero inference overhead, unlike the
    # score ensemble).  Judged on the same val reads.
    soup_err = float("inf")
    soup_base = os.path.join(args.out, f"soup_{ens_tag}")
    if len(ens_dirs) > 1 and not args.no_ensemble:
        t = time.time()
        _write_soup_dir(soup_base, ens_dirs)
        summ = basecall_and_eval(
            soup_base, val_reads, args.exp, "val", weights="99",
            batchsize=args.batch, ubs=args.ubs,
            out_dir=os.path.join(soup_base, "basecalls-val"),
            device=args.device, log=log)
        soup_err = float(summ.get("err_only_ub", float("inf")))
        log(f"> soup({len(ens_dirs)} seeds): val err_only_ub "
            f"{soup_err:.2f}")
        log(f"> [D] soup: wall time {time.time() - t:.1f} s")

    best_err, win_seed, workdir, best = min(candidates)
    out_base = None
    if ens_err < best_err and ens_err <= soup_err:
        best_err, win_seed, workdir, best = (
            ens_err, "ensemble", ens_dirs, 99)
        out_base = ens_base
    elif soup_err < best_err:
        best_err, win_seed, workdir, best = (
            soup_err, "soup", soup_base, 99)
        out_base = soup_base
    log(f"> WINNER: seed {win_seed} epoch {best} "
        f"(val err_only_ub {best_err:.2f})")
    if best is None:
        # no validation summary anywhere (e.g. micro smoke runs where
        # nothing aligns): fall back to the winner's last epoch so the
        # test phase still runs end-to-end
        best = args.epochs
        link = os.path.join(workdir, "weights_99.npz")
        if not os.path.exists(link):
            from xna_basecaller_tpu_torch.train import checkpoint as ckpt
            os.symlink(f"weights_{best}.npz", link)
            ckpt.mark_reserved(workdir, 99)
        log(f"> [WARNING] no val summaries; testing last epoch {best}")
    t = time.time()
    results = phase_e_test(args, workdir, test_reads, test_reads_ind,
                           out_base=out_base)
    log(f"> [E] wall time {time.time() - t:.1f} s")

    def _fin(x):  # inf -> null: keep the summary strict JSON
        return x if isinstance(x, (int, str)) or np.isfinite(x) else None

    win_dir = out_base or (workdir if isinstance(workdir, str)
                           else workdir[0])
    summary = {
        "exp": args.exp, "best_epoch": best, "best_seed": win_seed,
        # basename of the dir holding the winner's basecall/eval chain
        # (seed dir, ensemble_* or soup_*) — collectors must use this,
        # not a glob (stale membership-keyed dirs from resumed runs with
        # different seeds/epochs may coexist)
        "winner_dir": os.path.basename(win_dir.rstrip("/")),
        "val_err_only_ub": _fin(best_err),
        "seed_candidates": [
            {"seed": s, "best_epoch": b, "val_err_only_ub": _fin(e)}
            for e, s, _, b in sorted(candidates)],
        "ensemble_val_err_only_ub": _fin(ens_err),
        "soup_val_err_only_ub": _fin(soup_err),
        "wall_seconds": int(time.time() - t0),
    }
    for key, vals in results.items():
        name = {"test": "test_heldout",
                "test-ind": "test_in_distribution"}.get(key, key)
        summary[name] = {k: v for k, v in vals.items()
                         if isinstance(v, (int, float))}
    with open(os.path.join(args.out, "northstar_summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    log(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
