#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``xna_basecaller_tpu_torch``) on one NVIDIA
GPU, at the full width of the flagship model (conv 768, 5 x LSTM(768),
1512-column CRF, chunks of 3600; random weights from a seed): its three
paths, basecalling (batch 256; with the Viterbi, the q-score and the beam
decodes), the int8 ``--quantize`` basecall (batch 256) and training
(batch 64), plain and with the spike and stitch
augmentations, and the bootstrap-data phase that makes stitch's donors
(basecall, alignment, ctc-data, DTW breakpoints), and the paper's whole
north-star chain A -> E through the port's north-star script; and the
other model families and commands: the legacy QuartzNet CTC family
(basecall and train), the mods classifier (``basecaller --mods-model``),
duplex pair decoding (``xnacall duplex``), ``evaluate``, ``view`` and
``export``.

Phases, each of which fails the run (non-zero exit) if it fails:
  1. print the card's name and power limit, build every kernel in
     ``xna_basecaller_tpu_torch/csrc`` (nvcc, in parallel) and print the
     build log with the ptxas register and spill lines;
  2. hold each kernel against its plain PyTorch version on the card, on the
     tensors the main path gives it for one batch of simulated reads:
     K1 (LSTM recurrence) in bf16 and f32 (called twice: bit-equal or
     the phase fails), K1 in bf16 at the XNA model's batch of
     XNA_K1_ROWS rows (one launch on the wide geometry, twice, and
     bit-equal to its first 256 and last 128 rows run apart), and K1's
     f32 route at duplex's shapes
     (DUPLEX_K1_ROWS rows of a read's chunks, both directions, twice
     each), K7 (the int8 recurrence, layer
     0 of the quantized path) in bf16 and f32, K2a/K2b/K2c (CRF decode),
     the q-score variants of K2b and K2c (bp, v_final and labels
     bit-equal to the Viterbi kernels', edge_sel and probs against their
     plain versions) and the beam kernel at the widths BEAM_WIDTHS on the
     partials of K4 and K2a; then, at the shapes of ONT's R10.4.1 sup
     model (R10_CONFIG: 1024 CRF states, T=2000, N=256, H=1024), K2a, K2b
     and K2c on their wide path on its forward's scores (the wide-path
     counter reading 3) and K1 in bf16 (twice, bit-equal); the CRF
     head's epilogue kernel against the chain of PyTorch passes at the
     XNA and R10 heads (HEAD_SHAPES): bit-equal, one launch, on its
     tiled path as the launch reports;
  3. check the model's scores and labels against the plain CPU path on a
     small input, in f32 and quantized; the quantized model's scores
     against the bf16 model's on one batch; ``int8_matmul`` (cuBLASLt)
     against the CPU;
  4. set every launch count to 0, basecall simulated reads through
     ``infer.basecall.run_basecaller``, read the counts (the CRF head's
     kernel once a batch, on its tiled path), check every read; then the
     same with ``quantize=True`` (K7 five times a batch, K1 not at all,
     the head's kernel on the f32 product once a batch); 4c. with
     ``qscores=True`` (K2a, the q-score K2b and K2c once a batch, no
     Viterbi K2b or K2c) and ``beam_width=PIPELINE_BEAM`` (K4,
     K2a and the beam kernel once a batch), each read's qstring as long
     as its sequence and valid phred characters, the mean q printed;
     4d. with the counts set to 0, ``superbatch=2`` (two batches an
     upload): every read called as ``superbatch=1`` calls it, K1 5 times
     and K2a/b/c once per real batch; then the pipeline's samples/s at
     G = 1, 2 and 4 in turns; 4e. the random weights written as a
     reference-format ``weights_1.tar`` (bonito's key names) and as
     ``weights_1.npz``, both loaded by ``load_model`` on the card (load
     times in turns; weights and one batch's labels bit-equal), and
     ``make_sharded_scorer(devices=[cuda:0])``'s labels bit-equal to
     ``basecall``'s on the batch, both timed in turns;
  5. hold K3a (trainable LSTM forward) and K3b (its backward recursion)
     against their plain versions on the tensors of one training batch
     (T=720, N=64, H=768; layers 0 and 1, so both directions), in bf16
     and f32;
  6. hold the loss kernels K4 (forward scan), K5a (backward scan, K2a's
     kernel), K5b (edge posteriors), K6a and K6b (the stay/move lattice)
     against their plain versions on the tensors of one training batch
     (T=720, N=64, 1512 columns, 448 lattice positions), and ``ctc_loss``
     with its gradient through the kernels against the plain path on the
     CPU;
  7. one f32 training step of a small model on the card (every kernel of
     the step) against the same step on the CPU (plain versions): loss,
     grad_norm, parameters;
  8. set every launch count to 0, train the flagship model for 8 steps
     and one validation through the ``train`` CLI on simulated ctc-data,
     read the counts, check the losses, the moved weights and that
     ``weights_1.npz`` loads back;
  8b. hold ``spike_batch`` and ``stitch_batch`` on the card to the port's
     CPU run where no draw enters the result (B=64, T=3600); set every
     launch count to 0, train the flagship model for 4 steps and one
     validation through the ``train`` CLI with both augmentations
     (``--stitch --stitch-relax --spike --ubs XY --synth-prop-ubs 0.05``,
     donors from ``simulate_donor_dataset``) under ``--profile``, read the
     counts, check the losses and that the batches gained UBs, and read
     the card's busy share over the steps from the trace;
  8e. ``python -m torch.distributed.run --nproc-per-node 1 -m
     xna_basecaller_tpu_torch train`` (NCCL, world size 1) with phase 8's
     arguments on its ctc-data (8 steps and one validation): losses, grad
     norms, validation and weights against phase 8's run (a tolerance:
     the card's training step is not bit-repeatable, see
     ``drive_distributed_training``), both runs' step times;
  8c. the paper's bootstrap-data phase (B) on the card: 256 chunk-reads
     of 3600 through ``cli/basecaller.py::call_reads``, alone, then with
     the launch counts set to 0 with ``--reference`` (templates made from
     the first run's calls, on both strands), ``--save-ctc``,
     ``--ub-only``, ``--sam``, ``--bam`` and ``--cram``; read the counts,
     check the kept chunks, their UB targets, the SAM, the BAM and CRAM
     read back against it (and each writer's records/s), the calls that
     changed between the runs and ``filter_stats.csv``;
     ``dtw_segmentation`` with the native library; that the checkpoint
     ensemble ``[model, model]`` calls the
     256 chunk-reads as the model does; 2 steps of ``train --stitch
     --stitch-relax --ubs XY`` on
     B's ctc-data and its breakpoints (donors from phase 8b), then an
     epoch more with ``--restore-optim`` from the optimizer file in the
     JAX package's layout; print the chunk-reads/s of both runs, the
     alignment's time, DTW ms a chunk, both also against each template
     library (the port's ``XnaRefs``) at real read lengths, and the
     phase's wall time;
  8d. the paper's north-star chain A -> E through the port's script
     (``python -m xna_basecaller_tpu_torch.tools.spliced_northstar``'s
     ``main``) at the flagship's width, its depth cut (``NS_ARGV``), with
     the launch counts set to 0 just before and read just after: every
     kernel of the chain launched, phase B's ctc-data and breakpoints for
     both kinds, phase D's summary for each epoch of both seeds and its
     choice of epoch, phase E's summaries and ``northstar_summary.json``'s
     keys (JAX's); each phase's wall time is printed by the script;
  8f. the legacy QuartzNet CTC family at full width
     (``quartznet5x5_config("NACGTXY")``, random weights from SEED, the
     batchnorm running stats brought to the batch's): its log-probs on the
     card held to the port's CPU run of the same chunks, each block's time
     at 64 x 3600, ``basecall_ctc`` over phase 4's reads greedy and with
     beam 5 (every read called), the host decode of a read, a training
     step by stage, and ``train --config <quartznet toml>`` for 8 steps on
     phase 8's ctc-data (losses finite and falling, the batchnorm running
     stats moved, the validation loss finite, and again with the stats
     brought to the validation chunks');
  8g. ``mods.train.fit`` on the card on seeded synthetic sites (held-out
     accuracy >= 0.8), then with the launch counts set to 0
     ``call_reads`` with ``--mods-model --reference --bam`` over simulated
     reads through phase 8d's phase-A model: at least half the BAM's
     records carry MM/ML tags, and a read's site probabilities on the card
     equal the CPU's within 1e-5; ``call_mods``' time a read;
  8h. ``read_transition_probs`` on the card held to the CPU's plain route
     (K1's f32 route, the head's kernel on the f32 product once, and
     K2a), its stages; each pair through
     ``decode_pair``'s steps one at a time: the card's time a read, the
     host's simplex decodes, NW + envelope and pair Viterbi (with its
     cells), and the exit the pair takes; with the launch counts set to
     0, ``xnacall duplex --pairs --pair-decode`` over DUPLEX_PAIRS
     simulated template/complement pairs with phase A's model: one duplex
     read a pair, each equal to ``decode_pair``'s joint call or, where it
     made none, to the consensus merge's read; the accuracies against the
     simulated sequence beside the merge's and the simplex calls'; every
     pair through the match gate to the pair Viterbi, each complement's
     simplex identity >= 95 %, the joint calls' median >= 90 %, and a pair
     of unrelated strands turned down at the gate;
  8i. with the launch counts set to 0, ``xnacall evaluate --weights 1,2
     --poa`` on phase 8's ctc-data with phase A's checkpoints (both
     checkpoints and the POA reported, K1 and K2a/b/c on every batch),
     ``view``, and ``export`` of a one-layer model of the flagship's width;
  8j. the tail that needs no card: ``xnacall download --models`` from a
     ``file://`` mirror holding phase A's model and ``download --from`` a
     reference ``weights_1.tar`` of it, each install called on the card
     (with the launch counts set to 0) byte-equal to the source model on
     phase 4's first reads; ``comp_basecalls_perf`` over phase 8d's seeds
     reproducing the winner's summary; ``forensics`` on tables the phase
     writes; ``convert`` where h5py is installed;
  9. time each kernel, its plain version and its library yardstick with
     CUDA events: the CRF head's epilogue kernel and the chain of PyTorch
     passes it replaced as medians of 21 in turns at HEAD_SHAPES (the
     ``kernels`` line has the XNA head's); K1, K3a and K3b beside the
     port's like-for-like layer
     and cuDNN's ``nn.LSTM`` (flattened weights) as medians of 21 calls
     taken in turns, and K1's f32 route at duplex's 8 rows beside the
     port's f32 projection + K1 and cuDNN's f32 ``nn.LSTM`` (TF32 off),
     with the card's clock and power sampled beside them,
     and the rows sweep of the LSTM kernels K1, K3a, K3b and K7 (per-step
     time = a + b x rows, over N <= 64 and over 128-256 rows) and of K1's
     f32 route at F32_SWEEP_ROWS; K7 beside
     K1 on K7's input (bf16 W_hh) as medians of 21 in turns; with
     ``--baseline DIR``, the K1 (bf16 and f32) and K7 of that tree in the
     same turns; the
     CRF kernels K2a at the basecall batch, K5a, K4, the lattice's K6a and
     K6b at the training batch, K2b and K2c at the basecall batch and K2b,
     K2c and K6a at the validation batch's 16 rows, and the decode chain
     (K2a, logZ, K2b, K2c) at the basecall batch, as medians of 21 samples
     of 10 calls (with ``--baseline DIR``, in turns with that tree's
     kernels, whose betas, alphas, logZ, bp, v_final, labels, d_stay and
     d_move they must equal bit for bit), with the time a step, and K5b by
     the same statistic; the batch's other stages (conv, input
     projection, head, decode; for the quantized batch the int8
     projection and the int8 head), one batch through model and decode,
     the pipeline's samples/s over the same reads four times, both
     unquantized and quantized, one training step with its breakdown, and
     the step with and without the data-parallel all-reduces (an NCCL
     group of one rank in this process) in turns;
     ``spike_batch``, ``stitch_batch`` and their pick loop at 64 x 3600
     (CUDA events, and the card's share of one call of each by
     ``torch.profiler``), the augment closures with their numpy round trip
     (host clock), medians of 21 in turns, and the training step as the
     ``Trainer`` runs it with and without both augmentations (host clock);
     the decoders (``time_decoders``): the Viterbi, q-score and beam
     chains (BEAM_TIMED widths) and K4 at 256 rows in turns, the q-score
     K2b and K2c in turns with the Viterbi ones, the beam kernel alone
     (with ``--baseline DIR``, in turns with that tree's and bit-equal to
     it), each plain version once, one batch through the model and each
     decode, the pipeline's samples/s with ``qscores`` and with the beam,
     and the host's q-string, per-base loop against vectorised;
  10. print the whole run's wall time, the ``kernels`` JSON line, then
     the result line.

Run from the repository root:  python3 chip_smoke.py
To compare with another tree (e.g. the parent commit, unpacked with
``git archive`` into a directory that .gitignore lists) on the same card,
in the same turns:
    python3 chip_smoke.py --baseline DIR
Without a CUDA device (or without the package beside it) it exits non-zero
and prints no result.
"""

from __future__ import annotations

import collections
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from xna_basecaller_tpu_torch.ops import _build

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, dense int8 tensor-core OP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12

N_READS, MEAN_LEN, SEED = 16, 120_000, 0
TRAIN_BATCH, TRAIN_STEPS, VALID_CHUNKS = 64, 8, 16
# phase 8b: --chunks 272 of phase 8's data leaves 263 training chunks (4
# steps of 64) and 9 validation chunks (one batch)
AUG_CHUNKS, AUG_STEPS = 272, 4
# phase 8c: --chunks 136 of B's ctc-data leaves 131 training chunks (2
# steps of 64) and 5 validation chunks (one batch)
SPLICED_CHUNKS = 136
# phase 8c: the --ub-bias values tried for the calls the reference is made of
UB_BIASES = (0.0, -1.0, -2.0, -3.0, -4.0, -6.0, -10.0)
# phase 8c: K1 adds the chunks of h in index order, whatever order they
# arrive in, so a second basecall of the same 256 chunk-reads calls every
# read as the first did (the arrival-order sum changed 8-17 calls)
K1_DIFFER_MAX = 0
# phase 8c: the template libraries phase B aligns to (the port's copy,
# read through its XnaRefs), and the call of a chunk-read of 3600 samples
# at ~9 samples a base
LIBRARIES = ("XNA_4Ds", "POC", "XNA16", "CPLX")
CHUNK_CALL_BASES = 400
SCAN_BURST = 10   # calls a timed sample of the CRF kernels
# phase 2: K1's f32 route at duplex's shapes, the chunks of a read: 8 at
# phase 8h's 22.5 k samples, 32 at ~100 k; phase 9 times it at the first
DUPLEX_K1_ROWS = (8, 32)
# phase 2: K1 in bf16 at the XNA model's batch (its basecaller.batchsize),
# one launch on the wide geometry at H=768
XNA_K1_ROWS = 384
# phase 9: the rows swept for K1's f32 route
F32_SWEEP_ROWS = (8, 16, 32, 64, 128, 256)
# phase 8d: the north-star script's depth (its widths are the flagship's;
# PERF.md section 4 lists each cut): phase A's simulated DNA chunks and
# epochs, phase B's reads, phase C's epochs, two seeds (so that the
# ensemble and soup candidates run), the validation and test reads
NS_EPOCHS = 2
NS_ARGV = ["--boot-chunks", "8320", "--boot-epochs", "5",
           "--xna-reads", "200", "--dna-reads", "240",
           "--epochs", str(NS_EPOCHS), "--seeds", "25,26",
           "--val-reads", "64", "--test-reads", "64", "--n-proc", "8"]
# the keys of scripts/spliced_northstar.py's northstar_summary.json
NS_SUMMARY_KEYS = ["exp", "best_epoch", "best_seed", "winner_dir",
                   "val_err_only_ub", "seed_candidates",
                   "ensemble_val_err_only_ub", "soup_val_err_only_ub",
                   "wall_seconds", "test_heldout", "test_oracle",
                   "test_in_distribution", "test-ind_oracle", "POC-test",
                   "POC-test_oracle"]


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def elapsed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls after one warm-up,
    each call timed alone by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(fns: dict, reps: int = 21, burst: int = 1) -> dict:
    """Median device time of each function over ``reps`` samples, all taken
    in turns in one stretch: the order reverses every round (a, b, b, a,
    ...), so that a drift of the card's clock or power falls on every
    function alike.  A sample is ``burst`` calls back to back between two
    CUDA events, over ``burst``: with more than one, the card runs the
    calls without waiting for the host to enqueue each (for kernels of
    well under a millisecond, whose wrapper's host time would show)."""
    names = list(fns)
    for n in names:
        fns[n]()
    torch.cuda.synchronize()
    times = {n: [] for n in names}
    for r in range(reps):
        for n in names if r % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(burst):
                fns[n]()
            end.record()
            end.synchronize()
            times[n].append(start.elapsed_time(end) / burst)
    return {n: statistics.median(v) for n, v in times.items()}


def crf_ms(fn) -> float:
    """Median device time of a CRF kernel's wrapper ``fn``, as ``in_turns``
    takes it for the scans: 21 samples of SCAN_BURST calls back to back."""
    return in_turns({"fn": fn}, burst=SCAN_BURST)["fn"]


class CardSampler:
    """``nvidia-smi``'s SM clock, power draw and power limit, sampled every
    100 ms while the ``with`` block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        if rows:
            clk, draw, limit = (sorted(c) for c in zip(*rows))
            self.summary = (
                f"{len(rows)} samples: SM clock {clk[0]:.0f}-{clk[-1]:.0f} "
                f"MHz (median {statistics.median(clk):.0f}), power draw "
                f"{draw[0]:.1f}-{draw[-1]:.1f} W (median "
                f"{statistics.median(draw):.1f}), power limit {limit[-1]:.2f}"
                " W")
        else:
            self.summary = "not sampled"
        return False


def p99(t: torch.Tensor) -> float:
    """The 99th percentile of the elements of ``t`` (an order statistic)."""
    flat = t.flatten().float()
    return flat.kthvalue(math.ceil(0.99 * flat.numel())).values.item()


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def build_tree(root: str, names, tag: str, defines=()) -> dict:
    """The kernel sources ``names`` of another tree of this repository
    (``root``), built with nvcc from its ``xna_basecaller_tpu_torch/csrc``
    into this tree's build directory as ``<tag>_<name>.so``, all started
    together, with extra ``-D`` ``defines``; returns {name: CDLL}."""
    import ctypes

    from xna_basecaller_tpu_torch.ops import _build

    csrc = os.path.join(root, "xna_basecaller_tpu_torch", "csrc")
    os.makedirs(_build.BUILD, exist_ok=True)
    procs = {}
    for name in names:
        out = os.path.join(_build.BUILD, f"{tag}_{name}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
             "-o", out, os.path.join(csrc, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            fail(f"{tag}: {name}.cu of {root} does not build:\n{text}")
        libs[name] = ctypes.CDLL(out)
    return libs


def scan_kernels(libs: dict, tag: str) -> dict:
    """K2a, K2b, K2c and K4 through the C entry points of ``crf_decode``
    and ``crf_loss`` libraries built by ``build_tree``: {"K2a": fn(scores,
    n_base, state_len) -> betas, "K4": fn(scores, n_base, state_len) ->
    (alphas, logZ), "K2b": fn(scores, betas, logz, n_base, state_len) ->
    (bp, v_final), "K2c": fn(bp, v_final, n_base, state_len) -> labels}."""
    # typed as this tree's; the trailing pointer of K2a, K2b and K2c, this
    # tree's `wide` out-parameter, is null (an older tree's ignore it)
    backward = _build.entry("xna_crf_backward", libs["crf_decode"])
    forward = _build.entry("xna_crf_forward", libs["crf_loss"])
    viterbi = _build.entry("xna_crf_fwd_viterbi", libs["crf_decode"])
    traceback = _build.entry("xna_crf_traceback", libs["crf_decode"])

    def scan(is_forward, scores, n_base, state_len):
        T, N, _ = scores.shape
        ns = n_base ** state_len
        out = torch.empty(T + 1, N, ns, device=scores.device)
        stream = torch.cuda.current_stream().cuda_stream
        if is_forward:
            logz = torch.empty(N, device=scores.device)
            rc = forward(scores.data_ptr(), out.data_ptr(), logz.data_ptr(),
                         T, N, n_base, ns, stream)
        else:
            rc = backward(scores.data_ptr(), out.data_ptr(), T, N, n_base,
                          ns, stream, None)
        if rc:
            fail(f"{tag}: a CRF scan returned {rc}")
        return (out, logz) if is_forward else out

    def forward_viterbi(scores, betas, logz, n_base, state_len):
        T, N, _ = scores.shape
        ns = n_base ** state_len
        bp = torch.empty(T, N, ns, dtype=torch.uint8, device=scores.device)
        v_final = torch.empty(N, ns, device=scores.device)
        rc = viterbi(scores.data_ptr(), betas.data_ptr(), logz.data_ptr(),
                     bp.data_ptr(), v_final.data_ptr(), T, N, n_base, ns,
                     torch.cuda.current_stream().cuda_stream, None)
        if rc:
            fail(f"{tag}: its K2b returned {rc}")
        return bp, v_final

    def viterbi_traceback(bp, v_final, n_base, state_len):
        T, N, ns = bp.shape
        labels = torch.empty(N, T, dtype=torch.int8, device=bp.device)
        rc = traceback(bp.data_ptr(), v_final.data_ptr(), labels.data_ptr(),
                       T, N, n_base, ns,
                       torch.cuda.current_stream().cuda_stream, None)
        if rc:
            fail(f"{tag}: its K2c returned {rc}")
        return labels

    return {"K2a": lambda sc, nb, sl: scan(False, sc, nb, sl),
            "K4": lambda sc, nb, sl: scan(True, sc, nb, sl),
            "K2b": forward_viterbi, "K2c": viterbi_traceback}


def baseline_kernels(root: str) -> dict:
    """K1, K7, K2a, K2b, K2c, K4, K6a, K6b and, where that tree has it, the
    beam kernel of another tree of this repository (``--baseline DIR``,
    e.g. a ``git archive`` of the parent commit), to be timed in turns with
    this tree's.  Their C interface is this tree's, but the lattice's,
    which is that tree's (``lattice_kernels``); the scratch given K1 and K7
    is large enough for either tree's layout of h.
    Returns {"K1": fn(xp, w_hh, reverse), "K7": fn(xp, w_q, scale,
    reverse)} for bf16 xp of at most 256 rows, K2a, K2b, K2c and K4 as
    ``scan_kernels``, "lattice" as ``lattice_kernels`` and "beam" as
    ``beam_kernel``."""
    has_beam = os.path.exists(os.path.join(
        root, "xna_basecaller_tpu_torch", "csrc", "crf_beam.cu"))
    libs = build_tree(root, ("lstm_recurrence", "lstm_int8", "crf_decode",
                             "crf_loss") + ("crf_beam",) * has_beam,
                      "baseline")
    fns = {name: _build.entry(entry, libs[name]) for name, entry in (
        ("lstm_recurrence", "xna_lstm_recurrence"),
        ("lstm_int8", "xna_lstm_int8"))}

    def launch(name, xp, w, scale, reverse, h_dtype):
        T, N, H4 = xp.shape
        H = H4 // 4
        ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)
        hbuf = torch.zeros(2 * -(-N // 128) * 128 * -(-H // 128) * 128,
                           dtype=h_dtype, device=xp.device)
        flags = torch.zeros(H, dtype=torch.int32, device=xp.device)
        # K1: xp, w_hh, ys, cs (none), hbuf, flags, ..., wide (null)
        # K7: xp, w_q, scale, ys, hbuf, flags, ...
        if scale is None:
            ptrs, tail = (xp.data_ptr(), w.data_ptr(), ys.data_ptr(),
                          None), (None,)
        else:
            ptrs, tail = (xp.data_ptr(), w.data_ptr(), scale.data_ptr(),
                          ys.data_ptr()), ()
        rc = fns[name](*ptrs, hbuf.data_ptr(), flags.data_ptr(), T, N, N, H,
                       int(reverse), int(xp.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream, *tail)
        if rc:
            fail(f"the baseline tree's {name} kernel returned {rc}")
        return ys

    return {"K1": lambda xp, w, rev=False: launch(
                "lstm_recurrence", xp, w, None, rev, xp.dtype),
            "K7": lambda xp, w_q, scale, rev=False: launch(
                "lstm_int8", xp, w_q, scale, rev, torch.int8),
            **scan_kernels(libs, "the baseline tree"),
            "lattice": lattice_kernels(libs["crf_loss"], "the baseline tree"),
            **({"beam": beam_kernel(libs["crf_beam"], "the baseline tree")}
               if has_beam else {})}


def beam_kernel(lib, tag: str):
    """The beam kernel through the C entry point of a ``crf_beam`` library
    built by ``build_tree``: fn(scores, alphas, betas, logz, n_base,
    state_len, B) -> (labels [N, T] int8, best_score [N])."""
    fn = _build.entry("xna_crf_beam", lib)

    def run(scores, alphas, betas, logz, nb, sl, B):
        T, N, _ = scores.shape
        hist = torch.empty(N, T, B, dtype=torch.int16, device=scores.device)
        labels = torch.empty(N, T, dtype=torch.int8, device=scores.device)
        best = torch.empty(N, device=scores.device)
        rc = fn(scores.data_ptr(), alphas.data_ptr(), betas.data_ptr(),
                logz.data_ptr(), hist.data_ptr(), labels.data_ptr(),
                best.data_ptr(), T, N, nb, nb ** sl, B,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"{tag}'s beam kernel returned {rc}")
        return labels, best
    return run


def lattice_kernels(lib, tag: str) -> dict:
    """K6a and K6b through the C entry points of a ``crf_loss`` library
    built by ``build_tree``, by that tree's interface: the lattice packed
    as ``crf_cuda.lattice_pack`` packs it, with the alphas at row stride
    npad, where the library exports ``xna_lattice_depth``; else stay, move
    and the alphas as contiguous tensors (an older tree's).  Returns
    {"inputs": fn(stay, move) -> the lattice as the kernels read it,
    "K6a": fn(lattice, lengths) -> (alphas [T, N, n], logZ), "K6b":
    fn(lattice, lengths, alphas, logz, ct) -> (d_stay, d_move)}; lengths
    int32; K6b takes K6a's alphas without a copy."""
    import ctypes

    from xna_basecaller_tpu_torch.ops import crf_cuda

    packed = hasattr(lib, "xna_lattice_depth")
    if packed:
        fwd, bwd = (_build.entry(f"xna_lattice_{d}", lib)
                    for d in ("forward", "backward"))
    else:   # an older tree's: stay and move apart, one pointer more
        fwd, bwd = lib.xna_lattice_forward, lib.xna_lattice_backward
        for fn, d in ((fwd, "forward"), (bwd, "backward")):
            fn.argtypes = [ctypes.c_void_p] + _build.ENTRY_POINTS[
                f"xna_lattice_{d}"].argtypes
            fn.restype = ctypes.c_int

    def inputs(stay, move):
        rows = ((crf_cuda.lattice_pack(stay, move),) if packed
                else (stay.contiguous(), move.contiguous()))
        return rows, stay.shape

    def run(entry, ptrs, shape, what):
        rc = entry(*(t.data_ptr() for t in ptrs), *shape,
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"{tag}: its {what} returned {rc}")

    def forward(lattice, lengths):
        rows, (T, N, n) = lattice
        alphas = torch.empty(T, N, -(-n // 4) * 4 if packed else n,
                             device=lengths.device)
        logz = torch.empty(N, device=lengths.device)
        run(fwd, (*rows, lengths, alphas, logz), (T, N, n), "K6a")
        return alphas[:, :, :n], logz

    def backward(lattice, lengths, alphas, logz, ct):
        rows, (T, N, n) = lattice
        alphas = (crf_cuda._padded(alphas, -(-n // 4) * 4) if packed
                  else alphas.contiguous())
        d_stay = torch.empty(T, N, n, device=lengths.device)
        d_move = torch.empty(T, N, n - 1, device=lengths.device)
        run(bwd, (*rows, lengths, alphas, logz, ct, d_stay, d_move),
            (T, N, n), "K6b")
        return d_stay, d_move

    return {"inputs": inputs, "K6a": forward, "K6b": backward}


def check_trainable_kernels(model, chunks, targets, lengths):
    """Phase 5: K3a and K3b against their plain versions on the tensors of
    one training batch: each LSTM layer's xp and the gradient of its
    output from the loss's backward, for layers 0 (reverse) and 1.
    Returns the bf16 errors and layer 0's bf16 tensors for the timings."""
    from xna_basecaller_tpu_torch.models.crf_model import crf_head_forward
    from xna_basecaller_tpu_torch.ops import lstm, lstm_cuda
    from xna_basecaller_tpu_torch.ops.conv import conv_stack_forward

    cfg = model.cfg
    errs, keep = {}, None
    # tolerances: ys as K1's; cs and dxp relative to their largest element
    # (|c| grows to several units; the backward carries dh and dc over all
    # 720 steps, so a bf16 rounding flipped early moves later ones)
    for name, dtype, tol_y, tol_c, tol_dx in (
            ("bf16", torch.bfloat16, 5e-2, 2e-2, 5e-2),
            ("f32", torch.float32, 1e-4, 1e-4, 1e-3)):
        x = conv_stack_forward(model.conv, chunks[:, None, :],
                               cfg.encoder.activation)
        x = x.permute(2, 0, 1).to(dtype).contiguous()
        taps = []
        for layer, rev in zip(model.rnn, model.directions):
            p = layer.params(dtype)
            xp = lstm.input_projection(p, x)
            w = p["w_hh"].contiguous()
            ys = lstm_cuda.LSTMRecurrence.apply(xp, w, rev)
            ys.retain_grad()
            taps.append((xp, w, ys, rev))
            x = ys
        scores = crf_head_forward(model.head, model.head_ext, x, cfg)
        model.loss(scores, targets,
                   lengths.clamp(min=cfg.state_len + 1)).backward()
        model.zero_grad(set_to_none=True)
        for i in (0, 1):
            xp, w, ys, rev = taps[i]
            xp, w, dys = xp.detach(), w.detach(), ys.grad
            with torch.no_grad():
                ys_k, cs_k = lstm_cuda.lstm_forward_with_cells(xp, w, rev)
                ys_p, cs_p = lstm.lstm_recurrence_with_cells(xp, w, rev)
                # both backwards from the same residuals
                dxp_k = lstm_cuda.lstm_backward_dxp(dys, xp, w, ys_p, cs_p,
                                                    rev)
                dxp_p = lstm.lstm_backward_dxp(dys, xp, w, ys_p, cs_p, rev)
            torch.cuda.synchronize()
            e_y = (ys_k.float() - ys_p.float()).abs().max().item()
            r_c, r_dx = rel_err(cs_k, cs_p), rel_err(dxp_k, dxp_p)
            e_dx = (dxp_k.float() - dxp_p.float()).abs().max().item()
            print(f"K3a {name} layer {i} {tuple(xp.shape)} reverse={rev}: ys "
                  f"max_abs {e_y:.3e} (tolerance {tol_y}), cs max_rel "
                  f"{r_c:.3e} ({tol_c}); K3b dxp max_abs {e_dx:.3e} max_rel "
                  f"{r_dx:.3e} ({tol_dx}), max |dxp| "
                  f"{dxp_p.float().abs().max().item():.3e}")
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in (ys_k, cs_k, dxp_k))
            if not finite or e_y > tol_y or r_c > tol_c or r_dx > tol_dx:
                fail(f"K3a/K3b {name} disagree with their plain versions")
            if name == "bf16":
                errs["K3a"] = max(errs.get("K3a", 0.0), e_y)
                errs["K3b"] = max(errs.get("K3b", 0.0), e_dx)
                if i == 0:
                    keep = (xp, w, dys, ys_p, cs_p, rev)
        del taps, scores
    return errs, keep


def check_int8_kernel(model, x):
    """Phase 2 (K7): the int8 recurrence against its plain version on the
    card, on the quantized path's tensors of layer 0 (reverse) for one
    batch: xp is the int8 input projection of the conv output x, W_hh
    quantized per column, in bf16 and in f32.  Returns the bf16 error and
    the bf16 inputs for the timings."""
    from xna_basecaller_tpu_torch.ops import lstm, lstm_cuda

    layer, rev = model.rnn[0], model.directions[0]
    err_bf16, keep = None, None
    # max abs as K1's; in bf16 at most 1e-3 of ys differing at all: the
    # parity rule (bf16 h at even steps), without which ~30 % differ
    for name, dtype, tol in (("bf16", torch.bfloat16, 5e-2),
                             ("f32", torch.float32, 1e-4)):
        p = layer.params(dtype)
        xp = (lstm.int8_matmul(x.to(dtype), *lstm.quantize_w_hh(p["w_ih"]))
              + p["bias"]).to(dtype)
        w_q, scale = lstm.quantize_w_hh(p["w_hh"])
        got = lstm_cuda.lstm_recurrence_int8(xp, w_q, scale, rev)
        want = lstm.lstm_recurrence_int8(xp, w_q, scale, rev)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        share = (got != want).float().mean().item()
        hq = (torch.round(got.float() * 127) != torch.round(
            want.float() * 127)).float().mean().item()
        print(f"K7 {name} {tuple(xp.shape)} reverse={rev}: max_abs "
              f"{err:.3e} (tolerance {tol}), share of ys differing "
              f"{share:.3e}" + (" (tolerance 1e-3)" if name == "bf16" else "")
              + f", share of h_q = round(127 ys) differing {hq:.3e}")
        if not bool(torch.isfinite(got.float()).all()) or err > tol \
                or (name == "bf16" and share > 1e-3):
            fail(f"K7 {name} disagrees with its plain version")
        if name == "bf16":
            err_bf16, keep = err, (xp, w_q, scale, p["w_hh"], rev)
    return err_bf16, keep


def check_quantized_model(model, cpu_model, codes, scores):
    """Phase 3 (quantized): ``int8_matmul`` on the card against the CPU on
    the same input; the f32 quantized model on the card against the plain
    CPU path on 2 chunks; the quantized model's scores (int8 upload, bf16)
    against the bf16 model's on one batch."""
    from xna_basecaller_tpu_torch.models.crf_model import (
        QUANT_SCALE, crf_head_forward,
    )
    from xna_basecaller_tpu_torch.ops import crf, crf_cuda, lstm
    from xna_basecaller_tpu_torch.ops.conv import conv_stack_forward

    cfg = model.cfg
    nb, sl = cfg.n_base, cfg.state_len
    # the same int32 products and f32 scalings on both sides: 1e-6 of the
    # largest element, as the CPU tests hold int8_matmul against JAX
    x = conv_stack_forward(
        model.conv, (codes[:2].float() * (1.0 / QUANT_SCALE))[:, None, :],
        cfg.encoder.activation)
    x = x.permute(2, 0, 1).contiguous()
    p = model.rnn[0].params(torch.float32)
    w_q, w_s = lstm.quantize_w_hh(p["w_ih"])
    r_proj = rel_err(lstm.int8_matmul(x, w_q, w_s).cpu(),
                     lstm.int8_matmul(x.cpu(), w_q.cpu(), w_s.cpu()))
    r_head = rel_err(
        crf_head_forward(model.head, model.head_ext, x, cfg, int8=True).cpu(),
        crf_head_forward(cpu_model.head, cpu_model.head_ext, x.cpu(), cfg,
                         int8=True))
    print(f"int8_matmul card vs CPU, layer 0's projection {tuple(x.shape)} "
          f"x {tuple(w_q.shape)}: max_rel {r_proj:.3e}; int8 CRF head "
          f"max_rel {r_head:.3e} (tolerance 1e-6)")
    if r_proj > 1e-6 or r_head > 1e-6:
        fail("int8_matmul on the card disagrees with the CPU")
    # The quantized path is discontinuous: an ulp anywhere (the conv's sum
    # order, the CPU's exp) can flip one h_q, which moves the gates by a
    # quantum of the weights and flips more h_q downstream; at T=720 with
    # random weights that reaches most frames.  So the card is held to the
    # JAX package's own bounds for the int8 path (test_pallas.py:462-465):
    # mean |d| < 0.05 and 99th percentile < 0.5 on scores in [-5, 5]; the
    # share of label frames that differ is reported.
    sc_gpu = model(codes[:2], compute_dtype=torch.float32, lstm_int8=True)
    sc_cpu = cpu_model(codes[:2].cpu(), compute_dtype=torch.float32,
                       lstm_int8=True)
    d = (sc_gpu.cpu() - sc_cpu).abs()
    mean, q99 = d.mean().item(), p99(d)
    lab = (crf_cuda.decode_paths_cuda(sc_gpu, nb, sl).cpu()
           != crf.decode_paths(sc_cpu, nb, sl)).float().mean().item()
    print(f"f32 quantized model on the card vs the plain CPU path, 2 chunks: "
          f"scores mean_abs {mean:.3e} (tolerance 0.05), p99 {q99:.3e} (0.5),"
          f" max_abs {d.max().item():.3e}; label frames differing {lab:.3e} "
          f"(reported)")
    if not bool(torch.isfinite(sc_gpu).all()) or mean >= 0.05 or q99 >= 0.5:
        fail("the f32 quantized model on the card disagrees with the CPU")
    sc_q = model(codes, lstm_int8=True)
    d = (sc_q - scores).abs()
    mean, q99 = d.mean().item(), p99(d)
    print(f"quantized model (int8 upload, int8 projections and head, K7) vs "
          f"the bf16 model, one batch {tuple(sc_q.shape)}: mean_abs "
          f"{mean:.3e} (tolerance 0.05), p99 {q99:.3e} (0.5), max_abs "
          f"{d.max().item():.3e}")
    if sc_q.shape != scores.shape or not bool(torch.isfinite(sc_q).all()) \
            or mean >= 0.05 or q99 >= 0.5:
        fail("the quantized model's scores are not within the JAX bounds "
             "of the bf16 model's")


# phase 2: the decode's wide path and K1 at H=1024 at the shapes of ONT's
# R10.4.1 sup model (portbench's configuration of it): NACGT at state_len
# 5, 1024 CRF states x 5 columns, chunks of 10,000 samples (2000 frames),
# its batch of 256
R10_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "portbench", "configs",
                          "dna_r10.4.1_sup_v4.0.0.json")


@torch.inference_mode()
def check_r10_wide_path(dev) -> dict:
    """K2a, K2b and K2c on their wide path (past 256 states) through their
    wrappers, on the scores of the R10.4.1 sup model's forward (the port's
    initial weights from SEED) over a batch of the chunks of simulated
    reads, against their plain versions (ops/crf.py), at the tolerances of
    tests/test_torch_kernels_gpu.py's wide-path test: betas rtol 1e-5,
    backpointers and the chain's labels equal but for f32 near-ties (at
    most 1e-3), v_final within T x 1e-7 relative, K2c's labels of the same
    backpointers exact; the ``.wide`` counts of ``_build.launches`` read
    3 in all after the
    three launches.  The forward's five K1 launches take the split
    geometry (``launches["lstm_recurrence.split"]`` reads 5).  Then K1 in
    bf16 at the model's [2000, 256, 1024] against its plain version
    (max_abs 5e-2) and bit-equal over two calls."""
    from xna_basecaller_tpu_torch.core.config import from_dict
    from xna_basecaller_tpu_torch.data import chunkops
    from xna_basecaller_tpu_torch.data.simulate import simulate_reads
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.ops import crf, crf_cuda, lstm, lstm_cuda
    from xna_basecaller_tpu_torch.ops.conv import conv_stack_forward

    with open(R10_CONFIG) as fh:
        cfg = from_dict(json.load(fh)["model"])
    bc = cfg.basecaller
    nb, sl, T = cfg.n_base, cfg.state_len, bc.chunksize // cfg.encoder.stride
    chunks = np.concatenate([chunkops.chunk(r.signal, bc.chunksize,
                                            bc.overlap)
                             for r in simulate_reads(2 * N_READS,
                                                     mean_len=MEAN_LEN,
                                                     seed=SEED + 1)])
    if len(chunks) < bc.batchsize:
        fail(f"R10 wide path: {len(chunks)} chunks, fewer than a batch")
    batch = torch.from_numpy(chunks[:bc.batchsize]).to(dev)
    model = Model(cfg, device=dev, seed=SEED).eval()
    split = _build.launches["lstm_recurrence.split"]
    scores = model(batch)
    split = _build.launches["lstm_recurrence.split"] - split
    print(f"R10 forward: K1 launches on the split geometry {split} "
          "(expected 5)")
    if split != 5:
        fail(f"the R10 forward took {split} K1 launches on the split "
             "geometry, expected 5")
    if scores.shape != (T, bc.batchsize, cfg.n_score) \
            or not bool(torch.isfinite(scores).all()):
        fail(f"R10 scores {tuple(scores.shape)} not finite/expected")
    wide = [f"{w}.wide" for w in ("backward_scan", "forward_viterbi",
                                  "viterbi_traceback")]
    for key in wide:
        _build.launches[key] = 0
    betas = crf_cuda.backward_scan(scores, nb, sl)
    betas_p = crf.backward_scores(scores, nb, sl)
    rel = ((betas - betas_p).abs() / (1 + betas_p.abs())).max().item()
    logz = crf.logz_from_betas(betas)
    bp, v_final = crf_cuda.forward_viterbi(scores, betas, logz, nb, sl)
    bp_p, v_p = crf.forward_viterbi(scores, betas, logz, nb, sl)
    bp_share = (bp != bp_p).float().mean().item()
    v_err = (v_final - v_p).abs()
    v_ok = bool((v_err <= 1e-4 + 1e-7 * T * v_p.abs()).all())
    labels = crf_cuda.viterbi_traceback(bp, v_final, nb, sl)
    tb_diff = int((labels != crf.viterbi_traceback(bp, v_final, nb, sl)
                   ).sum().item())
    torch.cuda.synchronize()
    launches = sum(_build.launches[key] for key in wide)
    lab_share = (labels != crf.viterbi_traceback(bp_p, v_p, nb, sl)
                 ).float().mean().item()
    print(f"R10 wide path {tuple(scores.shape)} ({cfg.n_state} states): "
          f"K2a betas max_rel {rel:.3e} (tolerance 1e-5); K2b "
          f"backpointers differing {bp_share:.3e}, chain's label frames "
          f"differing {lab_share:.3e} (tolerance 1e-3), v_final max_abs "
          f"{v_err.max().item():.3e} (tolerance 1e-4 + {1e-7 * T:.1e} "
          f"|plain|); K2c labels "
          f"differing {tb_diff} (tolerance 0); launches on the wide path "
          f"{launches} (expected 3)")
    if rel > 1e-5:
        fail("K2a on the wide path disagrees with its plain version")
    if bp_share > 1e-3 or lab_share > 1e-3 or not v_ok:
        fail("K2b on the wide path disagrees with its plain version")
    if tb_diff:
        fail("K2c on the wide path disagrees with its plain version")
    if launches != 3:
        fail(f"the wide path counted {launches} launches, expected 3")
    out = {"K2a-wide_err": rel, "K2b-wide_label_share": lab_share}
    del betas, betas_p, bp, bp_p, scores

    layer0 = model.rnn[0]
    rev0 = model.directions[0]
    p = layer0.params(torch.bfloat16)
    x = conv_stack_forward(model.conv, batch.float()[:, None, :],
                           cfg.encoder.activation)
    xp = lstm.input_projection(
        p, x.permute(2, 0, 1).contiguous().to(torch.bfloat16))
    got = lstm_cuda.lstm_recurrence(xp, p["w_hh"], rev0)
    err = (got.float() - lstm.lstm_recurrence(xp, p["w_hh"], rev0).float()
           ).abs().max().item()
    again = lstm_cuda.lstm_recurrence(xp, p["w_hh"], rev0)
    print(f"K1 bf16 {tuple(xp.shape)} reverse={rev0}: max_abs {err:.3e} "
          f"(tolerance max_abs 5e-2); called twice: elements differing "
          f"{(again != got).float().mean().item():.4f} (tolerance 0)")
    if not bool(torch.isfinite(got.float()).all()) or err > 5e-2:
        fail("K1 bf16 at H=1024 disagrees with its plain version")
    if not torch.equal(again, got):
        fail("K1 bf16 at H=1024 is not bit-repeatable")
    out["K1-1024_err"] = err
    return out


# phases 2 and 9: the CRF head's epilogue at the heads of the XNA model's
# batch of 384 (NACGTXY at state_len 3: 1296 products, 1512 scores a
# frame) and of the R10.4.1 sup model's batch of 256 (NACGT at state_len 5:
# 4096 products, 5120 scores a frame), T, N, n_base, C
HEAD_SHAPES = {"XNA": (720, 384, 6, 1296), "R10": (2000, 256, 4, 4096)}
# phase 9: calls a timed sample of the head's kernel: back to back, so that
# its wrapper's ~30 us of host time a call (a tenth of the kernel at the
# XNA head) does not show, as it does not behind the head's product
HEAD_BURST = 5


def head_inputs(T, N, C, seed):
    """A head product [T, N, C] in bf16 from LSTM-like features (|x| < 1)
    and a head weight of the init's range, and a bias, made on the card."""
    g = torch.Generator("cuda").manual_seed(seed)
    H = 1024
    x = torch.tanh(torch.randn(T * N, H, device="cuda", generator=g))
    w = (torch.rand(H, C, device="cuda", generator=g) * 2 - 1) \
        * math.sqrt(6.0 / H)
    p = (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).view(T, N, C)
    b = ((torch.rand(C, device="cuda", generator=g) * 2 - 1)
         / math.sqrt(H)).to(torch.bfloat16)
    return p, b


@torch.inference_mode()
def check_crf_head(shape) -> float:
    """The CRF head's kernel against the chain of PyTorch passes at one of
    HEAD_SHAPES, scale 5 and blank 2: bit-equal, one launch, on its tiled
    path as the launch reports; -> the largest difference (0)."""
    from xna_basecaller_tpu_torch.ops import crf_head

    T, N, nb, C = HEAD_SHAPES[shape]
    p, b = head_inputs(T, N, C, SEED)
    k = crf_head.crf_head_epilogue
    keys = ("crf_head_epilogue", "crf_head_epilogue.tiled")
    before = [_build.launches[key] for key in keys]
    got = k(p, b, 5.0, 2.0, nb)
    torch.cuda.synchronize()
    launches, tiled = (_build.launches[key] - n
                       for key, n in zip(keys, before))
    want = crf_head.crf_head_chain(p, b, 5.0, 2.0, nb)
    differ = (got != want).sum().item()
    print(f"CRF head epilogue at the {shape} head {tuple(p.shape)} -> "
          f"{tuple(got.shape)}: launches {launches}, on its tiled path "
          f"{tiled} (expected 1 and 1), scores differing from the chain's "
          f"{differ} (tolerance 0)")
    if launches != 1 or tiled != 1:
        fail(f"the CRF head's kernel at the {shape} head took {launches} "
             f"launches, {tiled} on its tiled path")
    if differ or got.shape != want.shape:
        fail(f"the CRF head's kernel at the {shape} head differs from the "
             "chain")
    return (got - want).abs().max().item()


def head_bound(T, N, nb, C):
    """The epilogue's bound: the bf16 product and bias read, the f32 scores
    written; an add, a tanh and a multiply a product."""
    return bound(2 * T * N * C + 2 * C + 4 * T * N * C // nb * (nb + 1),
                 3 * T * N * C, PEAK_F32)


@torch.inference_mode()
def time_crf_head(card: str) -> dict:
    """The CRF head's kernel and the chain of PyTorch passes it replaced,
    medians of 21 samples of HEAD_BURST calls in turns at each of
    HEAD_SHAPES, beside the bound; -> {shape: (kernel ms, chain ms)}."""
    from xna_basecaller_tpu_torch.ops import crf_head

    out = {}
    for shape, (T, N, nb, C) in HEAD_SHAPES.items():
        p, b = head_inputs(T, N, C, SEED + 1)
        t = in_turns({
            "kernel": lambda: crf_head.crf_head_epilogue(p, b, 5.0, 2.0, nb),
            "chain": lambda: crf_head.crf_head_chain(p, b, 5.0, 2.0, nb)},
            burst=HEAD_BURST)
        b_ms, _ = head_bound(T, N, nb, C)
        print(f"time CRF head epilogue at the {shape} head {(T, N, C)}, "
              f"medians of 21 samples of {HEAD_BURST} calls in turns: "
              f"kernel {t['kernel']:.3f} ms, the "
              f"chain of PyTorch passes {t['chain']:.3f} ms; bound "
              f"{b_ms:.3f} ms (bytes), kernel at "
              f"{b_ms / t['kernel'] * 100:.1f} % of it, on {card}")
        out[shape] = (t["kernel"], t["chain"])
        del p, b
    return out


BEAM_WIDTHS = (1, 8, 32)      # phase 2: the beam kernel against its plain
BEAM_TIMED = (1, 4, 8, 16)    # phase 9: the beam decode chain's widths
PIPELINE_BEAM = 8             # phase 4: run_basecaller(beam_width=...)
NEAR_TIE_SHARE = 16           # phase 2: near ties in at most 1 row in 16
QUAL_BASES = 400              # phase 9: bases a chunk for the q-string


def check_decoders(scores, betas, logz, bp, v_final, labels, nb, sl):
    """Phase 2 (the q-score and beam decoders) on the flagship batch's
    scores [720, 256, 1512] and the Viterbi decode's betas, logZ, bp,
    v_final and labels: the q-score K2b's bp and v_final bit-equal to the
    Viterbi K2b's, its edge_sel within 4 ulps of |logZ| of the plain
    version's where their backpointers agree (the edge sums alpha, score,
    beta and -logZ, terms as large as |logZ|, whose last bits the two
    versions' alphas round differently); the q-score K2c's labels
    bit-equal to ``decode_paths_cuda``'s, its probs within 1e-5 of the
    plain version's on the same bp, v_final and edge_sel (f32, before the
    f16 cast); the beam kernel at each width of BEAM_WIDTHS against the
    plain beam on the card on the same scores and the partials of K4 and
    K2a: best_score within 1e-4 in every row, labels equal in every row
    whose winner leads the best other sequence by more than 1e-4 (the
    near ties are counted, and fail the phase in more than one row in
    NEAR_TIE_SHARE).  Returns the errors and the inputs of the
    timings."""
    from xna_basecaller_tpu_torch.ops import crf, crf_cuda

    bp_q, v_q, edge_sel = crf_cuda.forward_viterbi_qual(scores, betas, logz,
                                                        nb, sl)
    labels_q, probs = crf_cuda.viterbi_traceback_qual(bp_q, v_q, edge_sel,
                                                      nb, sl)
    chain = crf_cuda.decode_paths_cuda(scores, nb, sl)
    same = (torch.equal(bp_q, bp) and torch.equal(v_q, v_final)
            and torch.equal(labels_q, labels) and torch.equal(labels_q, chain))
    print(f"K2b/K2c q-score variants: bp, v_final and labels bit-equal to "
          f"the Viterbi kernels' and decode_paths_cuda's: {same}")
    if not same:
        fail("the q-score variants of K2b/K2c change the Viterbi decode")
    bp_p, _, edge_p = crf.forward_viterbi(scores, betas, logz, nb, sl,
                                          qual=True)
    agree = bp_q == bp_p
    edge_err = (edge_sel[agree] - edge_p[agree]).abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(logz.abs().max().item())) - 23)
    edge_tol = max(1e-5, 4 * ulp)
    _, probs_p = crf.viterbi_traceback(bp_q, v_q, nb, sl, edge_sel)
    probs_err = (probs - probs_p).abs().max().item()
    print(f"K2b q-score edge_sel vs plain where bp agree "
          f"({agree.float().mean().item():.6f} of them): max_abs "
          f"{edge_err:.3e} (tolerance {edge_tol:.3e}); K2c q-score probs vs "
          f"plain: max_abs {probs_err:.3e} (tolerance 1e-5); probs in "
          f"[{probs.min().item():.4f}, {probs.max().item():.4f}]")
    if not edge_err <= edge_tol or not probs_err <= 1e-5 \
            or agree.float().mean().item() < 1 - 1e-3 \
            or not bool(torch.isfinite(probs).all()):
        fail("the q-score variants of K2b/K2c disagree with their plain "
             "versions")
    del edge_p, bp_p

    alphas, logz_a = crf_cuda.forward_scan(scores, nb, sl)
    parts = (alphas, betas, logz_a)
    beam_err = 0.0
    for B in BEAM_WIDTHS:
        got, best = crf_cuda.beam_search(scores, *parts, nb, sl, B)
        want, best_p, merged, winner = crf._beam_search(scores, *parts, nb,
                                                        sl, B)
        err = (best - best_p).abs().max().item()
        # the winner's lead over the best other sequence of the final beams
        gap = best_p - torch.where(winner, -1e38, merged).amax(-1)
        clear = gap > 1e-4
        ties = int((~clear).sum().item())
        rows_differ = (got != want).any(1)
        bad = int((rows_differ & clear).sum().item())
        print(f"beam kernel B={B} vs plain on the card: best_score max_abs "
              f"{err:.3e} (tolerance 1e-4), rows differing "
              f"{int(rows_differ.sum().item())}, of them near ties "
              f"{int((rows_differ & ~clear).sum().item())} (rows with a "
              f"near tie: {ties} of {len(gap)}, at most "
              f"{len(gap) // NEAR_TIE_SHARE}), others {bad} (tolerance 0)")
        if not err <= 1e-4 or bad or ties > len(gap) // NEAR_TIE_SHARE:
            fail(f"the beam kernel disagrees with its plain version at "
                 f"B={B}")
        beam_err = max(beam_err, err)
    return ({"K2b-qual": edge_err, "K2c-qual": probs_err, "beam": beam_err},
            (bp_q, v_q, edge_sel, parts))


def scan_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (1 + |want|): |a - b| <= 1e-5 + 1e-5 |b| as one
    ratio."""
    return ((got - want).abs() / (1 + want.abs())).max().item()


def check_loss_kernels(model, chunks, targets, lengths):
    """Phase 6: K4, K5a, K5b, K6a and K6b against their plain versions on
    the card, on one training batch's tensors (the scores of the model's
    training forward, T=720, N=64, 1512 columns; the lattice of its
    targets, 448 positions), then ``ctc_loss`` and its gradient through
    the kernels against the plain path on the CPU.  Returns the errors and
    the tensors for the timings."""
    from xna_basecaller_tpu_torch.ops import crf, crf_cuda

    nb, sl = model.cfg.n_base, model.cfg.state_len
    lengths = lengths.clamp(min=sl + 1)
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        scores = model(chunks, inference=False).float().contiguous()
        T, N, C = scores.shape
        # cotangents of the size the loss's mean over rows gives them
        ct, ct_lat = (torch.randn(N, generator=g).to(scores.device) / N
                      for _ in range(2))
        alphas, logz = crf_cuda.forward_scan(scores, nb, sl)
        alphas_p = crf.forward_scores(scores, nb, sl)
        logz_p = crf.logz_from_alphas(alphas_p)
        betas = crf_cuda.backward_scan(scores, nb, sl)
        betas_p = crf.backward_scores(scores, nb, sl)
        post = crf_cuda.edge_posteriors(scores, alphas_p, betas_p, logz_p, ct)
        post_p = crf.edge_posteriors(scores, alphas_p, betas_p, logz_p, ct)
        norm = crf.normalise(scores, nb, sl)
        stay, move = crf.prepare_ctc_scores(norm, targets, nb, sl)
        # packed once, as the loss hands them to K6a and K6b
        stay, move = crf_cuda.lattice_unpack(
            crf_cuda.lattice_pack(stay, move), stay.shape[2])
        lat_len = lengths + 1 - sl
        lat_a, lat_z = crf_cuda.lattice_forward(stay, move, lat_len)
        lat_a_p, lat_z_p = crf.lattice_forward(stay, move, lat_len)
        d_stay, d_move = crf_cuda.lattice_backward(
            stay, move, lat_len, lat_a_p, lat_z_p, ct_lat)
        d_stay_p, d_move_p = crf.lattice_backward(
            stay, move, lat_len, lat_a_p, lat_z_p, ct_lat)
    torch.cuda.synchronize()
    errs = {
        "K4 alphas (max |a-b|/(1+|b|), 1e-5)": scan_rel(alphas, alphas_p),
        "K4 logZ (max rel, 1e-5)": ((logz - logz_p).abs()
                                    / logz_p.abs()).max().item(),
        "K5a betas (max |a-b|/(1+|b|), 1e-5)": scan_rel(betas, betas_p),
        "K5b posteriors x ct (rel to largest, 1e-4)": rel_err(post, post_p),
        "K6a alphas (max |a-b|/(1+|b|), 1e-5)": scan_rel(lat_a, lat_a_p),
        "K6a logZ (max rel, 1e-5)": ((lat_z - lat_z_p).abs()
                                     / lat_z_p.abs()).max().item(),
        "K6b d_stay (rel to largest, 1e-4)": rel_err(d_stay, d_stay_p),
        "K6b d_move (rel to largest, 1e-4)": rel_err(d_move, d_move_p),
    }
    # the loss and its gradient: kernels on the card, plain path on the CPU
    out = {}
    for dev in ("cuda", "cpu"):
        x = scores.to(dev, copy=True).requires_grad_()
        loss = model.loss(x, targets.to(dev), lengths.to(dev))
        loss.backward()
        out[dev] = (loss.item(), x.grad.cpu())
    errs["ctc_loss (rel, 1e-5)"] = abs(out["cuda"][0] - out["cpu"][0]) \
        / abs(out["cpu"][0])
    # A posterior is exp() of alpha + score + beta - logZ, terms as large as
    # |logZ| (~5e3 here): one ulp of rounding there (4.9e-4 at 4096-8192),
    # which the card's and the CPU's exp/log can leave, moves it by that
    # factor.  So the card-vs-CPU gradient is held to two such ulps, and to
    # the CPU tests' 1e-4 where that is larger (short chunks).
    ulp = 2.0 ** (math.floor(math.log2(logz_p.abs().max().item())) - 23)
    grad_tol = max(1e-4, 2 * ulp)
    errs[f"ctc_loss gradient (rel to largest, {grad_tol:.3e})"] = rel_err(
        out["cuda"][1], out["cpu"][1])
    print(f"loss kernels vs plain on one training batch (T={T}, N={N}, "
          f"C={C}, n={stay.shape[2]}): " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f"; loss {out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f}, max "
          f"|grad| {out['cpu'][1].abs().max().item():.3e}")
    tols = {k: float(k.rsplit(", ", 1)[1].rstrip(")")) for k in errs}
    finite = all(bool(torch.isfinite(t).all()) for t in (
        alphas, logz, betas, post, lat_a, lat_z, d_stay, d_move))
    bad = [k for k, v in errs.items() if not v <= tols[k]]
    if not finite or bad:
        fail(f"loss kernels disagree with their plain versions: {bad}")
    max_abs = {
        "K4": (alphas - alphas_p).abs().max().item(),
        "K5a": (betas - betas_p).abs().max().item(),
        "K5b": (post - post_p).abs().max().item(),
        "K6a": (lat_a - lat_a_p).abs().max().item(),
        "K6b": max((d_stay - d_stay_p).abs().max().item(),
                   (d_move - d_move_p).abs().max().item()),
    }
    keep = (scores, alphas_p, betas_p, logz_p, ct, stay, move, lat_len,
            lat_a_p, lat_z_p, ct_lat)
    return max_abs, keep


def check_step_against_cpu():
    """Phase 7: one f32 training step of a small model (64 features, 2
    layers, chunks of 1200) on the card and on the CPU from the same
    weights and batch."""
    from xna_basecaller_tpu_torch.core.config import (
        EncoderConfig, ModelConfig,
    )
    from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.train.loop import (
        make_optimizer, train_step,
    )

    cfg = ModelConfig(encoder=EncoderConfig(features=64, num_rnn_layers=2))
    c, t, l, _ = simulate_ctc_dataset(8, chunk_len=1200, target_len=130,
                                      seed=SEED)
    out = {}
    for dev in ("cuda", "cpu"):
        model = Model(cfg, device=dev, seed=SEED)
        batch = [torch.from_numpy(a).to(dev) for a in (
            c.astype(np.float32), t.astype(np.int64), l.astype(np.int64))]
        loss, gn = train_step(model, make_optimizer(model, lambda _: 1e-3),
                              *batch, compute_dtype=torch.float32)
        out[dev] = (loss.item(), gn.item(),
                    {k: v.cpu() for k, v in model.state_dict().items()})
    (l_g, g_g, p_g), (l_c, g_c, p_c) = out["cuda"], out["cpu"]
    r_loss, r_gn = abs(l_g - l_c) / abs(l_c), abs(g_g - g_c) / abs(g_c)
    # AdamW's first step moves an element by ~lr whatever |g|: a gradient
    # component within rounding of zero may take either sign, so a few
    # elements may differ by up to two steps; the rest within 2e-6
    share = max(((p_g[k] - p_c[k]).abs() > 2e-6).float().mean().item()
                for k in p_c)
    worst = max((p_g[k] - p_c[k]).abs().max().item() for k in p_c)
    print(f"f32 train step, card vs CPU (64 features, 2 layers, 8 x 1200): "
          f"loss {l_g:.6f} vs {l_c:.6f} rel {r_loss:.3e} (tolerance 1e-4), "
          f"grad_norm {g_g:.6f} vs {g_c:.6f} rel {r_gn:.3e} (1e-3), "
          f"parameters: largest share of elements off by > 2e-6 {share:.3e} "
          f"(1e-3), max abs {worst:.3e} (2.2e-3)")
    if r_loss > 1e-4 or r_gn > 1e-3 or share > 1e-3 or worst > 2.2e-3:
        fail("the f32 training step on the card disagrees with the CPU")


def training_wrappers() -> dict:
    """The kernel wrappers of the training path, whose ``launches`` count
    their launches; K5a is K2a's kernel: one counter for both."""
    from xna_basecaller_tpu_torch.ops import crf_cuda, lstm_cuda

    return {"K1": lstm_cuda.lstm_recurrence,
            "K2a": crf_cuda.backward_scan,
            "K2b": crf_cuda.forward_viterbi,
            "K2c": crf_cuda.viterbi_traceback,
            "K3a": lstm_cuda.lstm_forward_with_cells,
            "K3b": lstm_cuda.lstm_backward_dxp,
            "K4": crf_cuda.forward_scan,
            "K5b": crf_cuda.edge_posteriors,
            "K6a": crf_cuda.lattice_forward,
            "K6b": crf_cuda.lattice_backward}


def zero_launches(wrappers: dict) -> None:
    """Zero the wrappers' launch counts (``_build.launches``)."""
    for w in wrappers.values():
        _build.launches[w.__name__] = 0


def launch_counts(wrappers: dict) -> dict:
    """{label: its wrapper's launches} (``_build.launches``)."""
    return {k: _build.launches[w.__name__] for k, w in wrappers.items()}


def check_training_launches(launches: dict, steps: int, n_valid: int,
                            where: str):
    """Fails unless each training kernel launched at least as often as
    ``steps`` steps and ``n_valid`` validation batches of the flagship
    need: 5 LSTM layers a step (K3a, K3b) or a validation batch (K1); the
    loss's scans every step; the validation runs the loss without
    gradients (K4 and K6a only) and the decode."""
    from xna_basecaller_tpu_torch.core.config import ModelConfig

    n_layers = ModelConfig().encoder.num_rnn_layers
    need = {"K3a": n_layers * steps, "K3b": n_layers * steps,
            "K1": n_layers * n_valid, "K2a": steps + n_valid,
            "K2b": n_valid, "K2c": n_valid, "K4": steps + n_valid,
            "K5b": steps, "K6a": steps + n_valid, "K6b": steps}
    for k, n in need.items():
        if launches[k] < n:
            fail(f"{k} launched {launches[k]} times on {where}, expected at "
                 f"least {n}")


def drive_training(workroot: str):
    """Phase 8: the training path through the ``train`` CLI; returns the
    launch counts of the run, the number of steps and the step times."""
    import csv
    import os

    from xna_basecaller_tpu_torch.cli import main as cli
    from xna_basecaller_tpu_torch.core.config import ModelConfig
    from xna_basecaller_tpu_torch.data.ctc_data import save_ctc_data
    from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.utils.model_io import load_model
    from xna_basecaller_tpu_torch.utils.weights import params_to_jax

    data, run = os.path.join(workroot, "data"), os.path.join(workroot, "run")
    n_train = TRAIN_STEPS * TRAIN_BATCH
    # the 97/3 split of load_datasets leaves exactly VALID_CHUNKS
    save_ctc_data(data, *simulate_ctc_dataset(
        n_train + VALID_CHUNKS, chunk_len=3600, target_len=400, seed=SEED))
    wrappers = training_wrappers()
    zero_launches(wrappers)
    t0 = time.perf_counter()
    cli(["train", run, "--directory", data, "--epochs", "1", "--batch",
         str(TRAIN_BATCH), "--seed", str(SEED), "--device", "cuda", "-f"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(wrappers)
    with open(os.path.join(run, "losses_1.csv")) as fh:
        rows = list(csv.DictReader(fh))
    with open(os.path.join(run, "training.csv")) as fh:
        val = list(csv.DictReader(fh))
    steps = len(rows)
    losses = [float(r["loss"]) for r in rows]
    gns = [float(r["grad_norm"]) for r in rows]
    print(f"training path: {steps} steps of {TRAIN_BATCH} x 3600 + one "
          f"validation of {VALID_CHUNKS} chunks in {wall:.1f} s; losses "
          f"{[round(v, 4) for v in losses]}, grad_norms "
          f"{[round(v, 3) for v in gns]}; validation {val[-1]}; launches "
          f"{launches}")
    if steps != TRAIN_STEPS or not all(math.isfinite(v)
                                       for v in losses + gns):
        fail("the training run did not give finite losses for every step")
    if not math.isfinite(float(val[-1]["validation_loss"])):
        fail("the validation loss is not finite")
    check_training_launches(launches, steps,
                            math.ceil(VALID_CHUNKS / TRAIN_BATCH),
                            "the training path")
    model, _ = load_model(run, device="cuda")
    saved = params_to_jax(model.state_dict())
    start = params_to_jax(Model(ModelConfig(), device="cpu",
                                seed=SEED).state_dict())
    moved = [k for k in saved if not np.array_equal(saved[k], start[k])]
    print(f"weights_1.npz loads back; {len(moved)} of {len(saved)} "
          "parameters moved")
    if len(moved) != len(saved):
        fail("training left parameters where they started")
    times = [float(r["time"]) for r in rows]
    return launches, steps, np.diff(times)


def drive_distributed_training(workroot: str, card: str):
    """Phase 8e: ``python -m torch.distributed.run --nproc-per-node 1 -m
    xna_basecaller_tpu_torch train`` (NCCL, world size 1: this script
    needs one card), in a process of its own, with phase 8's
    arguments on phase 8's ctc-data (8 steps and one validation), against
    phase 8's run of the same command without the launcher.  The launched
    run must join an NCCL group (its log says so; nothing catches a
    failure to).  Bit-equality is printed; the check is a tolerance,
    because the card's training step is not bit-repeatable from one run to
    the next, launcher or not (``torch.gather``'s backward in the loss adds
    with atomics where a target repeats a state, and 8 steps of AdamW
    carry an ulp on: losses 3e-5 and the validation loss 5e-5 apart,
    grad norms 9e-4, on an H100 80GB HBM3 at 700 W):
    losses and the validation loss rtol 1e-3, grad norms rtol 1e-2 (a sum
    of squares dominated by few elements), weights within 2 x the
    learning rates' sum (AdamW moves an element by about lr whatever its
    gradient's size).  Prints both runs' step times (host clock,
    ``losses_1.csv``; the launcher sets OMP_NUM_THREADS=1)."""
    import csv
    import socket

    from xna_basecaller_tpu_torch.train.checkpoint import load_flat

    data = os.path.join(workroot, "data")
    runs = {"plain (phase 8)": os.path.join(workroot, "run"),
            "torch.distributed.run": os.path.join(workroot, "dist")}
    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "1", "--master-port", str(port), "-m", "xna_basecaller_tpu_torch",
         "train", runs["torch.distributed.run"], "--directory", data,
         "--epochs", "1", "--batch", str(TRAIN_BATCH), "--seed", str(SEED),
         "--device", "cuda", "-f"], cwd=root,
        env={**os.environ, "PYTHONPATH": root}, capture_output=True,
        text=True, timeout=300)
    log = p.stdout + p.stderr
    print(f"phase 8e, train under torch.distributed.run: exit "
          f"{p.returncode} in {time.perf_counter() - t0:.1f} s")
    if p.returncode:
        print(log[-4000:])
        fail("the train CLI failed under torch.distributed.run")
    if "[nccl process group: rank 0 of 1" not in log:
        fail("the launched train run did not join an NCCL process group")

    def table(name, f):
        with open(os.path.join(runs[name], f)) as fh:
            return list(csv.DictReader(fh))

    a, b = (table(n, "losses_1.csv") for n in runs)
    va, vb = (table(n, "training.csv")[-1] for n in runs)
    wa, wb = (load_flat(os.path.join(runs[n], "weights_1.npz")) for n in runs)
    col = {k: [(float(x[k]), float(y[k])) for x, y in zip(a, b)]
           for k in ("loss", "grad_norm")}
    rel = {k: max(abs(x - y) / abs(x) for x, y in v) for k, v in col.items()}
    bit = (all(x == y for v in col.values() for x, y in v)
           and all(va[k] == vb[k] for k in ("validation_loss",
                                            "validation_mean",
                                            "validation_median"))
           and all(np.array_equal(wa[k], wb[k]) for k in wa))
    w_err = max(float(np.abs(wa[k] - wb[k]).max()) for k in wa)
    step = 2 * sum(float(r["lr"]) for r in a)
    print(f"phase 8e against phase 8's plain run: {len(b)} and {len(a)} "
          f"steps; losses max rel diff {rel['loss']:.3e} (rtol 1e-3), grad "
          f"norms {rel['grad_norm']:.3e} (rtol 1e-2); validation loss "
          f"{vb['validation_loss']} / {va['validation_loss']}; weights max "
          f"abs diff {w_err:.3e} (tolerance {step:.3e}); bit-equal: {bit}")
    for name, rows in (("plain (phase 8)", a), ("torch.distributed.run", b)):
        times = np.diff([0.0] + [float(r["time"]) for r in rows]) * 1e3
        print(f"phase 8e step times, {name} (ms, host clock at each step's "
              f"enqueue; the first with its warm-up): "
              f"{[round(float(v), 2) for v in times]}, median of steps 3.. "
              f"{statistics.median(times[2:]):.2f} on {card}")
    if len(a) != len(b) or not all(
            np.isclose(x, y, rtol=1e-3, atol=0) for x, y in col["loss"]) \
            or not all(np.isclose(x, y, rtol=1e-2, atol=0)
                       for x, y in col["grad_norm"]):
        fail("the launched run's steps, losses or grad norms differ")
    if not np.isclose(float(va["validation_loss"]),
                      float(vb["validation_loss"]), rtol=1e-3, atol=0) \
            or w_err > step:
        fail("the launched run's validation or weights differ")


def fixed_augment_batch(periodic: bool, B: int = TRAIN_BATCH,
                        L: int = 450, T: int = 3600):
    """A batch whose spike and stitch results no draw enters: targets of 21
    bases (position 10 is the only one 10 bases from either end; periodic
    ones mirror their context, so exact-context donors exist) in chunks of
    T samples, breakpoints from the simulator."""
    from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
    from xna_basecaller_tpu_torch.data.simulate import (
        MIRROR_HEX, simulate_squiggle,
    )

    pore = load_pore_model()
    rng = np.random.default_rng(SEED)
    chunks = rng.normal(size=(B, T)).astype(np.float32)
    targets = np.zeros((B, L), np.int32)
    bkps = np.zeros((B, L), np.int32)
    for i in range(B):
        t = (np.tile(MIRROR_HEX, 6)[i % 6: i % 6 + 21] if periodic
             else rng.integers(1, 5, size=21)).astype(np.uint8)
        sig, bk = simulate_squiggle(t, pore, rng)
        targets[i, :21] = t
        bkps[i, :21] = np.minimum(bk[:21], T)
        chunks[i, :min(T, len(sig))] = sig[:T]
    return chunks, targets, np.full(B, 21, np.int32), bkps


def check_augment_card_vs_cpu(tables_cap1):
    """Phase 8b: ``spike_batch`` and ``stitch_batch`` on the card against the
    port's CPU run at B=64 and T=3600, where no draw enters the result
    (``fixed_augment_batch``; one UB code; spike with k-mer stds 0 and no
    noise, also fully synthetic; stitch from one donor a bucket, exact and
    relaxed on random DNA): targets and success equal, chunks within 1e-6
    (an f32 ulp of the normalised levels)."""
    from xna_basecaller_tpu_torch.augment import spike, stitch
    from xna_basecaller_tpu_torch.data.pore_model import load_pore_model

    pore = load_pore_model()
    zero_stds = np.zeros_like(pore.stds)
    tbl = tables_cap1
    fallback = stitch.build_relax_fallback(tbl.counts).astype(np.int64)
    cases = {
        name: (True, lambda gen, dev, b, kw=kw: spike.spike_batch(
            gen, *b, *(torch.from_numpy(a).to(dev) for a in (
                pore.means, zero_stds)), noise_std=0.0, ub_codes=(5,), **kw))
        for name, kw in (("spike", {}),
                         ("spike fully synthetic", {"fully_synth": True}))
    }
    for relax in (False, True):
        cases[f"stitch{' relaxed' if relax else ''}"] = (
            not relax, lambda gen, dev, b, relax=relax: stitch.stitch_batch(
                gen, *b, *(torch.from_numpy(a).to(dev) for a in (
                    tbl.signals, tbl.lens, tbl.counts)), ub_codes=(6,),
                tbl_fallback=(torch.from_numpy(fallback).to(dev) if relax
                              else None)))
    report = []
    for name, (periodic, fn) in cases.items():
        batch = fixed_augment_batch(periodic)
        out = {}
        for dev in ("cuda", "cpu"):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            res = fn(gen, dev, [torch.from_numpy(a).to(dev) for a in batch])
            out[dev] = [r.cpu().numpy() for r in res]
        (c_g, t_g, *s_g), (c_c, t_c, *s_c) = out["cuda"], out["cpu"]
        err = float(np.max(np.abs(c_g - c_c) / (1 + np.abs(c_c))))
        inserted = int((t_g[:, 10] != batch[1][:, 10]).sum())
        report.append(f"{name}: chunks max |a-b|/(1+|b|) {err:.3e}, "
                      f"inserted at position 10 in {inserted} of "
                      f"{len(t_g)}")
        if (not np.array_equal(t_g, t_c) or err > 1e-6
                or any(not np.array_equal(a, b) for a, b in zip(s_g, s_c))
                or inserted != len(t_g)):
            fail(f"{name} on the card disagrees with the CPU")
    print("augmentation on the card vs the CPU (B=64, T=3600, no draw in "
          "the result; targets and success equal, tolerance 1e-6): "
          + "; ".join(report))


def busy_share(trace_path: str, span: str = "train_steps"):
    """The card's busy share over the profiler span ``span`` of the Chrome
    trace that ``torch.profiler`` wrote: the union of the kernels'
    intervals over the window from the span's start to the end of the last
    kernel launched within it (the host enqueues ahead of the card).
    Returns (share, window ms, busy ms, kernels launched in the span,
    [(name, ms)] of the 8 largest by summed time), or None where the trace
    holds no kernel."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("name") == span
             and e.get("cat") == "user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("ph") == "X"]
    if not spans or not kernels:
        return None
    t0 = spans[0]["ts"]
    t1 = t0 + spans[0]["dur"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and t0 <= e["ts"] <= t1
                and "correlation" in e.get("args", {})}
    mine = [k for k in kernels
            if k.get("args", {}).get("correlation") in launched]
    if not mine:
        return None
    end = max(k["ts"] + k["dur"] for k in mine)
    busy, last = 0.0, t0
    for a, b in sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels):
        a, b = max(a, last), min(b, end)
        if b > a:
            busy += b - a
            last = b
    by_name = {}
    for k in mine:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return busy / (end - t0), (end - t0) / 1e3, busy / 1e3, len(mine), top


def drive_augmented_training(workroot: str):
    """Phase 8b: the training path with both augmentations through the
    ``train`` CLI on the card: ``--stitch --stitch-relax --spike --ubs XY
    --synth-prop-ubs 0.05`` with donors from ``simulate_donor_dataset`` (a
    single-UB library with mirrored contexts), 4 steps of 64 and one
    validation on phase 8's ctc-data, under ``--profile``.  First holds the
    augmentations on the card to the CPU (``check_augment_card_vs_cpu``).
    Counts the UBs of the batches before and after the augmentation, checks
    the losses and the launch counts, and reads the card's busy share over
    the steps from the trace.  Returns the donor tables (cap 32)."""
    import csv

    from xna_basecaller_tpu_torch.augment.stitch import slice_xna_tables
    from xna_basecaller_tpu_torch.cli import main as cli
    from xna_basecaller_tpu_torch.data import ctc_data
    from xna_basecaller_tpu_torch.data.simulate import simulate_donor_dataset

    data, donors = (os.path.join(workroot, d) for d in ("data", "donors"))
    run, prof = (os.path.join(workroot, d) for d in ("aug_run", "profile"))
    ctc_data.save_ctc_data(donors, *simulate_donor_dataset(40, seed=SEED))
    check_augment_card_vs_cpu(slice_xna_tables(donors, cap=1))

    # the UBs of the training batches before and after the augmentation
    seen = {"batches": 0, "in": 0, "out": 0}
    load = ctc_data.load_datasets

    def counting(*a, augment=None, **kw):
        def counted(c, t, l, b, rng):
            seen["batches"] += 1
            seen["in"] += int((t > 4).sum())
            c, t = augment(c, t, l, b, rng)
            seen["out"] += int((t > 4).sum())
            return c, t
        return load(*a, augment=counted if augment else None, **kw)

    wrappers = training_wrappers()
    ctc_data.load_datasets = counting
    try:
        zero_launches(wrappers)
        t0 = time.perf_counter()
        cli(["train", run, "--directory", data, "--chunks", str(AUG_CHUNKS),
             "--epochs", "1", "--batch", str(TRAIN_BATCH), "--seed",
             str(SEED), "--device", "cuda", "-f", "--stitch",
             "--stitch-relax", "--spike", "--ubs", "XY", "--synth-prop-ubs",
             "0.05", "--xna-ctc-dir", donors, "--profile", prof])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(wrappers)
    finally:
        ctc_data.load_datasets = load
    with open(os.path.join(run, "losses_1.csv")) as fh:
        rows = list(csv.DictReader(fh))
    with open(os.path.join(run, "training.csv")) as fh:
        val = list(csv.DictReader(fh))[-1]
    losses = [float(r["loss"]) for r in rows]
    print(f"augmented training path (stitch relaxed + spike, XY, under "
          f"--profile): {len(rows)} steps of {TRAIN_BATCH} x 3600 + one "
          f"validation in {wall:.1f} s; losses "
          f"{[round(v, 4) for v in losses]}; validation loss "
          f"{val['validation_loss']}; UBs in the {seen['batches']} training "
          f"batches {seen['in']} -> {seen['out']} after the augmentation; "
          f"launches {launches}")
    if len(rows) != AUG_STEPS or not all(math.isfinite(v) for v in losses):
        fail("the augmented training run did not give finite losses for "
             "every step")
    if not math.isfinite(float(val["validation_loss"])):
        fail("the augmented validation loss is not finite")
    if seen["batches"] != AUG_STEPS or seen["out"] <= seen["in"]:
        fail("the augmentation inserted no UB into the training batches")
    check_training_launches(launches, len(rows), 1,
                            "the augmented training path")
    share = busy_share(os.path.join(prof, "trace.json"))
    if share is None:
        print("card busy share over the augmented steps: not measured (the "
              "trace holds no kernel)")
    else:
        frac, window, busy, n, top = share
        print(f"card busy share over the augmented steps (trace of "
              f"--profile, span train_steps): {frac:.4f} ({busy:.2f} of "
              f"{window:.2f} ms, {n} kernels); largest kernels: "
              + ", ".join(f"{k[:60]} {v:.2f} ms" for k, v in top))
    return slice_xna_tables(donors)


def time_library_alignment(align, chunksize: int, card: str):
    """Phase 8c at the traffic of real reads, which random weights do not
    call: for each template library of ``LIBRARIES`` (the templates of the
    port's ``XnaRefs``), the CLI's ``align`` (every template, both strands)
    of 8 probes of the templates' own length (a library read: a template
    with its N called X and 5 % of its bases substituted, every other one
    reverse-complemented) and of 8 of ``CHUNK_CALL_BASES`` (such a template
    inside random flanks: the call of a chunk-read of ``chunksize``
    samples), and DTW (``segment_read``, native ``dtw_band``) of 8
    simulated chunks of ``chunksize`` samples onto their template.  Prints
    the host-clock ms of each and the chunk-reads/s that they leave
    phase B; fails if a probe aligns to nothing."""
    from xna_basecaller_tpu_torch.core.alphabet import (
        CODE, reverse_complement_str,
    )
    from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
    from xna_basecaller_tpu_torch.data.simulate import simulate_squiggle
    from xna_basecaller_tpu_torch.eval.xna_refs import XnaRefs
    from xna_basecaller_tpu_torch.tools.dtw_segmentation import segment_read

    rng = np.random.default_rng(SEED)
    pore = load_pore_model()

    def random_bases(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    def called(t):
        q = np.array(list(t.replace("N", "X")))
        pos = rng.choice(len(q), size=len(q) // 20, replace=False)
        q[pos] = rng.choice(list("ACGT"), size=len(pos))
        return "".join(q)

    def align_ms(probes, want):
        t0 = time.perf_counter()
        got = [align(q, targets)[0] for q in probes]
        ms = (time.perf_counter() - t0) / len(probes) * 1e3
        if any(m is None for m in got):
            fail(f"a probe of library {name} aligned to nothing")
        return ms, sum(m["target_id"] == w for m, w in zip(got, want))

    for name in LIBRARIES:
        targets = XnaRefs(name).targets
        ids = list(targets)
        picks = [ids[i] for i in rng.choice(len(ids), size=8,
                                            replace=len(ids) < 8)]
        reads, chunks, dtw_in = [], [], []
        for i, tid in enumerate(picks):
            t = called(targets[tid])
            flank = CHUNK_CALL_BASES - len(t)
            c = random_bases(flank // 2) + t + random_bases(flank - flank // 2)
            codes = np.array([CODE[b] for b in c])
            sig, _ = simulate_squiggle(codes, pore, rng)
            dtw_in.append((sig[:chunksize], len(t),
                           np.array([CODE[b] for b in t])))
            if i % 2:
                t, c = reverse_complement_str(t), reverse_complement_str(c)
            reads.append(t)
            chunks.append(c)
        ms_read, hits_read = align_ms(reads, picks)
        ms_chunk, hits_chunk = align_ms(chunks, picks)
        t0 = time.perf_counter()
        seg = [segment_read(*x, pore) for x in dtw_in]
        ms_dtw = (time.perf_counter() - t0) / len(dtw_in) * 1e3
        lens = sorted(len(v) for v in targets.values())
        print(f"library {name} ({len(targets)} templates of {lens[0]}-"
              f"{lens[-1]} bases): the CLI's alignment {ms_read:.2f} ms a "
              f"read of its template's length, {ms_chunk:.2f} ms a "
              f"chunk-read's call of {CHUNK_CALL_BASES} bases (on their "
              f"template {hits_read} and {hits_chunk} of 8); DTW "
              f"{ms_dtw:.2f} ms a chunk of {chunksize} samples onto its "
              f"template (DTW-aligned {sum(ok for _, ok in seg)} of 8): "
              f"phase B at most {1e3 / (ms_chunk + ms_dtw):.1f} chunk-reads/s"
              f" on this host's one core (host clock, native sw_score_batch"
              f" + sw_align, dtw_band; {card})")


def check_binary_outputs(sam_records, bam_path: str, cram_path: str,
                         written, targets: dict, card: str):
    """Phase 8c's BAM and CRAM, read back against its SAM: a record for
    each SAM record, in order, with its name, flag, template, position,
    mapq, cigar, sequence (X/Y as N, BAM's folding) and quality; the
    CRAM's unmapped records with the sequence and quality as called (the
    SAM's reverse-complemented back where the flag is 16) and the SAM's
    read group.  Then each writer's records/s on the same records (host
    clock, the file's opening and closing included, median of 3)."""
    from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
    from xna_basecaller_tpu_torch.data.bam import BamWriter, read_bam
    from xna_basecaller_tpu_torch.data.cram import CramWriter, read_cram

    refs, bam = read_bam(bam_path)
    _, cram = read_cram(cram_path)
    names = [n for n, _ in refs]

    def from_bam(b):
        return (b["query_name"], str(b["flag"]),
                names[b["ref_id"]] if b["ref_id"] >= 0 else "*",
                str(b["pos"] + 1), str(b["mapq"]),
                "".join(f"{n}{op}" for op, n in b["cigar"]) or "*",
                b["seq"], b["qual"], b["tags"])

    def from_sam(r):
        return (*r[:6], "".join(c if c in "ACGTN" else "N" for c in r[9]),
                r[10], r[11:])

    def cram_of_sam(r):
        rc = r[1] == "16"
        return (r[0], reverse_complement_str(r[9]) if rc else r[9],
                r[10][::-1] if rc else r[10], r[11:])

    bam_bad = sum(from_bam(b) != from_sam(r)
                  for b, r in zip(bam, sam_records))
    cram_bad = sum((c["read_id"], c["seq"], c["qstring"], c["tags"])
                   != cram_of_sam(r) for c, r in zip(cram, sam_records))
    print(f"phase B's BAM and CRAM read back: {len(bam)} and {len(cram)} "
          f"records for the SAM's {len(sam_records)}; differing from the "
          f"SAM's: BAM {bam_bad}, CRAM {cram_bad} (tolerance 0)")
    if len(bam) != len(sam_records) or len(cram) != len(sam_records) \
            or bam_bad or cram_bad:
        fail("phase B's BAM or CRAM does not hold the SAM's records")
    tmp = os.path.join(os.path.dirname(bam_path), "timed")
    rg = sam_records[0][11].split(":", 2)[2] if sam_records else None
    for name, cls in (("BAM", BamWriter), ("CRAM", CramWriter)):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            w = cls(tmp, targets, read_group=rg)
            for a in written:
                w.write(*a)
            w.close()
            ts.append(time.perf_counter() - t0)
        print(f"{name} writer: {len(written)} records in "
              f"{[round(t * 1e3, 2) for t in ts]} ms, "
              f"{len(written) / statistics.median(ts):.0f} records/s "
              f"(median of 3, host clock) on {card}")


def drive_bootstrap_data(workroot: str, model, cfg, reads, card: str):
    """Phase 8c: the paper's bootstrap-data phase (B) on the card at the
    flagship's width, then its output feeding spliced training (C).

    256 chunk-reads of 3600 (one basecall batch) from phase 4's simulated
    reads go through ``cli/basecaller.py::call_reads`` twice: alone
    (FASTQ), then, with the launch counts set to 0, with ``--reference``
    (templates made from the first run's calls), ``--save-ctc``,
    ``--ub-only`` and ``--sam``; every other template is reverse-
    complemented, so the SAM holds both flags 0 and 16 and the targets
    both UB codes 5 ('+') and 6 ('-').  The random weights move on ~1 %
    of the frames, and call X/Y on many of those; a read's X/Y matches no
    template base.  So both runs pass the ``--ub-bias`` of ``UB_BIASES``
    whose calls hold the most canonical bases (a bias below 0 trades X/Y
    moves for canonical moves or stays), and the writer's filters are
    lowered to accuracy 0.2 and coverage 0.5.  Checks the counts (K1 5,
    K2a/b/c 1), the kept chunks, their UB targets, the chunks against the
    inputs' f16 slices, ``filter_stats.csv``, the SAM, and that at most
    ``K1_DIFFER_MAX`` (0) calls of the second run differ from the
    first's, and that the ensemble ``[model, model]`` calls what the model
    calls; then
    ``dtw_segmentation`` with the native library (``breakpoints.npy``
    monotone, ending at or below 3600).  Then phase C on B's output: 2
    steps of ``train --stitch --stitch-relax --ubs XY`` whose training
    data is B's ctc-data with its DTW breakpoints (stitch splices at
    them), donors from phase 8b's library (B's targets of ~10 bases over
    3600 samples have k-mers far longer than the 100 samples stitch takes
    from a donor; the count of B's donor slices is printed),
    ``--save-optim-every 1``, then one more epoch with
    ``--restore-optim`` from the optimizer file, which must hold the JAX
    package's keys.  Also prints whether two forwards of the batch are
    bit-equal, and times the alignment and DTW against the repo's template
    libraries (``time_library_alignment``), at the lengths of real calls,
    which random weights do not give."""
    import csv
    import types

    from xna_basecaller_tpu_torch.augment.stitch import slice_xna_tables
    from xna_basecaller_tpu_torch.cli import basecaller
    from xna_basecaller_tpu_torch.cli import main as cli
    from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
    from xna_basecaller_tpu_torch.data import bam as bam_mod
    from xna_basecaller_tpu_torch.data.fast5 import read_chunks
    from xna_basecaller_tpu_torch.data.simulate import self_reference
    from xna_basecaller_tpu_torch.eval.xna_refs import read_fasta
    from xna_basecaller_tpu_torch.ops import crf_cuda, lstm_cuda
    from xna_basecaller_tpu_torch.tools.dtw_segmentation import (
        dtw_segmentation,
    )
    from xna_basecaller_tpu_torch.train.checkpoint import load_flat
    from xna_basecaller_tpu_torch.utils import native

    t_phase = time.perf_counter()
    if not native.available():
        fail("the native library (native/xna_native.cpp) did not build: "
             "phase B would align and segment through the numpy fallbacks")
    chunksize, batchsize = cfg.basecaller.chunksize, cfg.basecaller.batchsize
    chunk_reads = []
    for r in reads:
        read = types.SimpleNamespace(
            read_id=r.read_id, signal=r.signal, run_id="sim", filename="",
            mux=0, channel=0, start=0.0, duration=0.0)
        chunk_reads.extend(read_chunks(read, chunksize=chunksize,
                                       overlap=cfg.basecaller.overlap))
    chunk_reads = chunk_reads[:batchsize]
    if len(chunk_reads) != batchsize:
        fail(f"only {len(chunk_reads)} chunk-reads: fewer than one batch")
    bdir = os.path.join(workroot, "bootstrap")
    ctc_dir, fasta = os.path.join(bdir, "ctc"), os.path.join(bdir, "ref.fa")
    os.makedirs(bdir)

    def run(bias, *flags):
        out = io.StringIO()
        args = basecaller.argparser().parse_args(
            ["flagship", "reads", "--ub-bias", str(bias), *flags])
        t0 = time.perf_counter()
        stats = basecaller.call_reads(args, model, cfg, iter(chunk_reads),
                                      out=out)
        torch.cuda.synchronize()
        return stats, out.getvalue(), time.perf_counter() - t0

    # the card's repeatability: two forwards of the batch, bit for bit
    x = torch.from_numpy(np.stack([c.signal for c in chunk_reads]).astype(
        np.float16)).to(next(model.parameters()).device)
    with torch.inference_mode():
        a, b = model(x), model(x)
    print(f"two forwards of the phase-B batch: scores bit-equal "
          f"{torch.equal(a, b)}, max abs {(a - b).abs().max().item():.3e}")
    del x, a, b

    # 1. the basecall alone, at each bias; phase B takes the bias whose
    # calls hold the most canonical bases
    ladder = []
    for bias in UB_BIASES:
        _, fastq, t = run(bias)
        lines = fastq.split("\n")
        c = dict(zip((h[1:] for h in lines[0::4]), lines[1::4]))
        canonical = sum(len(v) - v.count("X") - v.count("Y")
                        for v in c.values())
        ladder.append((canonical, bias, t, c))
    print("phase B calls by --ub-bias (canonical bases of the 256 calls, "
          "s): " + ", ".join(f"{b}: {n} ({t:.3f})"
                             for n, b, t, _ in ladder))
    _, bias, t_call, calls = max(ladder, key=lambda x: x[0])
    # random weights call a few nested strings (one inside another's
    # template ties, and ties go to '+'): take the orientation of the
    # templates under which the fewer of the calls on one strand are most
    counts = collections.Counter(calls.values())

    def strands_of(reverse_first):
        n = self_reference(calls.values(), fasta,
                           reverse_first=reverse_first)
        targets = read_fasta(fasta)
        on = collections.Counter()
        for c, k in counts.items():
            m = basecaller.align(c, targets)[0] if c and targets else None
            on[m["strand"] if m else "unmapped"] += k
        return min(on["+"], on["-"]), n, on

    reverse_first = max((False, True), key=lambda r: strands_of(r)[0])
    _, n_templates, strands = strands_of(reverse_first)
    lengths = sorted(len(v) for v in calls.values())
    ub_share = sum(v.count("X") + v.count("Y") for v in calls.values()) \
        / max(sum(lengths), 1)
    print(f"phase B step 1, the basecall alone at --ub-bias {bias}: "
          f"{len(chunk_reads)} "
          f"chunk-reads of {chunksize} in {t_call:.3f} s, "
          f"{len(chunk_reads) / t_call:.1f} chunk-reads/s (host clock) on "
          f"{card}; calls {len(calls)}, lengths min {lengths[0]} median "
          f"{lengths[len(lengths) // 2]} max {lengths[-1]}, X/Y share "
          f"{ub_share:.3f}; templates (distinct calls of >= 8 bases, every "
          f"other one reverse-complemented) {n_templates}")
    print("phase B step 1's most frequent calls: " + ", ".join(
        f"{c} x{k}" for c, k in counts.most_common(6)) + f"; on the "
        f"templates (first reverse-complemented: {reverse_first}) they "
        f"align {dict(strands)}")
    # a checkpoint ensemble of the model with itself: (s + s) / 2 = s in
    # f32 and K1 is repeatable, so it calls what the model calls
    from xna_basecaller_tpu_torch.infer.basecall import basecall

    def calls_of(members):
        return {r.read_id: a["sequence"] for r, a in basecall(
            members, iter(chunk_reads), chunksize=chunksize,
            overlap=cfg.basecaller.overlap, batchsize=batchsize,
            ub_bias=bias)}
    _build.launches["lstm_recurrence"] = 0
    alone, ensemble = calls_of(model), calls_of([model, model])
    n_ens = sum(alone[k] != ensemble[k] for k in alone)
    print(f"ensemble [m, m] against m alone on the {len(alone)} "
          f"chunk-reads: calls differing {n_ens} (tolerance 0); K1 "
          f"launches {_build.launches['lstm_recurrence']} (expected "
          f"{3 * cfg.encoder.num_rnn_layers})")
    if n_ens or len(alone) != batchsize or \
            _build.launches["lstm_recurrence"] != \
            3 * cfg.encoder.num_rnn_layers:
        fail("the ensemble [m, m] does not call what m calls")
    if n_templates == 0:
        fail("no call of 8 bases or more: nothing to build a reference of")
    if min(strands["+"], strands["-"]) < 8:
        fail("fewer than 8 of step 1's calls align to one of the strands "
             "in either orientation of the templates")

    # 2. with the reference, the SAM and the ctc-data writer
    wrappers = {"K1": lstm_cuda.lstm_recurrence,
                "K2a": crf_cuda.backward_scan,
                "K2b": crf_cuda.forward_viterbi,
                "K2c": crf_cuda.viterbi_traceback}
    align, spent, mapped = basecaller.align, [0, 0.0], []

    def timed_align(seq, targets):
        t0 = time.perf_counter()
        try:
            mapping, refseq = align(seq, targets)
        finally:
            spent[0] += 1
            spent[1] += time.perf_counter() - t0
        if mapping is not None:
            mapped.append((mapping["percent_match"], (
                mapping["read_end"] - mapping["read_start"]) / len(seq)))
        return mapping, refseq

    # the BAM writer's calls, to time both writers on them afterwards
    bam_path, cram_path = (os.path.join(bdir, f"calls.{k}")
                           for k in ("bam", "cram"))
    written, bam_write = [], bam_mod.BamWriter.write

    def recorded_write(self, *a, **kw):
        written.append(a)
        return bam_write(self, *a, **kw)

    zero_launches(wrappers)
    basecaller.align = timed_align
    bam_mod.BamWriter.write = recorded_write
    try:
        stats, sam, t_b = run(bias, "--reference", fasta, "--save-ctc",
                              ctc_dir,
                              "--ub-only", "--sam", "--ctc-min-accuracy",
                              "0.2", "--ctc-min-coverage", "0.5", "--bam",
                              bam_path, "--cram", cram_path)
    finally:
        basecaller.align = align
        bam_mod.BamWriter.write = bam_write
    launches = launch_counts(wrappers)
    need = {"K1": cfg.encoder.num_rnn_layers, "K2a": 1, "K2b": 1, "K2c": 1}
    print(f"phase B step 2, the basecall with alignment and the writer: "
          f"{stats['reads']} chunk-reads in {t_b:.3f} s, "
          f"{stats['reads'] / t_b:.1f} chunk-reads/s (host clock) on {card};"
          f" alignment {spent[1]:.3f} s over {spent[0]} calls "
          f"({spent[1] / max(spent[0], 1) * 1e3:.2f} ms a call, "
          f"{len(calls)} x {n_templates} templates x 2 strands); mapped "
          f"{len(mapped)}, accuracy quartiles "
          f"{np.percentile([m[0] for m in mapped] or [0], [25, 50, 75])}, "
          f"coverage quartiles "
          f"{np.percentile([m[1] for m in mapped] or [0], [25, 50, 75])}; "
          f"launches {launches} (expected {need})")
    if launches != need:
        fail("phase B did not go through the kernels once a batch")
    records = [l.split("\t") for l in sam.splitlines()
               if not l.startswith("@")]
    n_called = sum(1 for v in calls.values() if v)
    by_flag = {f: sum(1 for r in records if r[1] == f)
               for f in ("0", "16", "4")}
    # step 2 cuts each chunk-read into one chunk-read of its own: id ":1:1"
    first = {r[0]: calls[r[0].rsplit(":", 2)[0]] for r in records}
    other = [(r[0], r[9], first[r[0]]) for r in records
             if (reverse_complement_str(r[9]) if r[1] == "16" else r[9])
             != first[r[0]]]
    print(f"SAM: {len(records)} records for {n_called} called chunk-reads "
          f"(flags {by_flag}); calls that differ from step 1's: "
          f"{len(other)} (at most {K1_DIFFER_MAX})"
          + (f", e.g. {other[0]}" if other else ""))
    if len(records) != n_called:
        fail(f"the SAM holds {len(records)} records for {n_called} called "
             "chunk-reads")
    check_binary_outputs(records, bam_path, cram_path, written,
                         read_fasta(fasta), card)
    if len(other) > K1_DIFFER_MAX:
        fail(f"{len(other)} of {n_called} calls changed between two "
             f"basecalls of the same chunk-reads, more than {K1_DIFFER_MAX}")
    if not by_flag["0"] or not by_flag["16"]:
        fail("phase B's SAM holds no record on one of the strands")
    if not os.path.exists(os.path.join(ctc_dir, "chunks.npy")):
        fail("phase B kept no chunk")
    kept = np.load(os.path.join(ctc_dir, "chunks.npy"))
    refs = np.load(os.path.join(ctc_dir, "references.npy"))
    ref_lens = np.load(os.path.join(ctc_dir, "reference_lengths.npy"))
    with open(os.path.join(ctc_dir, "filter_stats.csv")) as fh:
        fstats = {k: int(v) for k, v in csv.reader(fh) if k}
    failed = (sum(fstats[k] for k in (
        "count_failed_seq", "count_failed_map", "non_ubs_skipped",
        "count_failed_acc", "count_failed_cov"))
        - fstats["count_failed_both"])
    inputs = {np.asarray(c.signal[:chunksize], np.float16).tobytes()
              for c in chunk_reads}
    n5 = int((refs == 5).any(axis=1).sum())
    n6 = int((refs == 6).any(axis=1).sum())
    print(f"phase B output: {len(kept)} chunks kept of {stats['reads']}; "
          f"targets with a 5 (X, '+') {n5}, with a 6 (Y, '-') "
          f"{n6}; lengths {int(ref_lens.min())}-{int(ref_lens.max())}; "
          f"filter_stats {fstats}; passed the filters "
          f"{stats['reads'] - failed}, of which the typical-length filter "
          f"kept {len(kept)}")
    if not ((refs == 5) | (refs == 6)).any(axis=1).all():
        fail("a kept target holds no UB code under --ub-only")
    if not n5 or not n6:
        fail("no kept target holds the UB code of one of the strands")
    if not all(k.tobytes() in inputs for k in kept):
        fail("a kept chunk is not the f16 slice of a chunk-read")
    if not len(kept) <= stats["reads"] - failed <= stats["reads"]:
        fail("filter_stats.csv's counts do not add up to the reads")

    # 3. DTW breakpoints
    t0 = time.perf_counter()
    bkps, ok = dtw_segmentation(ctc_dir, log=lambda *a: None)
    t_dtw = time.perf_counter() - t0
    rows = [bkps[i, :int(ref_lens[i])].astype(np.int64)
            for i in range(len(bkps))]
    print(f"DTW breakpoints: {len(bkps)} chunks in {t_dtw:.3f} s, "
          f"{t_dtw / len(bkps) * 1e3:.2f} ms a chunk (host, native "
          f"dtw_band); DTW-aligned {int(ok.sum())} of {len(ok)} "
          f"({ok.mean():.3f}), the rest naive")
    if not os.path.exists(os.path.join(ctc_dir, "breakpoints.npy")) or any(
            np.any(np.diff(r) < 0) or r[-1] > chunksize for r in rows):
        fail("breakpoints.npy is missing, not monotone or past the chunk")
    time_library_alignment(align, chunksize, card)

    # 4. spliced training (C) on B's output, resumed
    print(f"B's chunks as stitch donors: "
          f"{int(slice_xna_tables(ctc_dir).counts.sum())} slices")
    if len(kept) < SPLICED_CHUNKS:
        fail(f"phase B kept {len(kept)} chunks, fewer than the "
             f"{SPLICED_CHUNKS} of 2 training steps and a validation")
    run_dir = os.path.join(bdir, "spliced")
    train_args = ["train", run_dir, "--directory", ctc_dir, "--chunks",
                  str(SPLICED_CHUNKS), "--batch", str(TRAIN_BATCH), "--seed",
                  str(SEED), "--device", "cuda", "-f", "--stitch",
                  "--stitch-relax", "--ubs", "XY", "--xna-ctc-dir",
                  os.path.join(workroot, "donors"), "--save-optim-every",
                  "1"]
    twrappers = training_wrappers()
    for epochs, extra in ((1, []), (2, ["--restore-optim"])):
        zero_launches(twrappers)
        cli([*train_args, "--epochs", str(epochs), *extra])
        torch.cuda.synchronize()
        tl = launch_counts(twrappers)
        with open(os.path.join(run_dir, f"losses_{epochs}.csv")) as fh:
            losses = [float(r["loss"]) for r in csv.DictReader(fh)]
        optim = load_flat(os.path.join(run_dir, f"optim_{epochs}.npz"))
        print(f"spliced training on phase B's ctc-data, epoch {epochs}"
              f"{' (--restore-optim)' if extra else ''}: losses "
              f"{[round(v, 4) for v in losses]}; optimizer count "
              f"{int(optim.get('1/0/count', -1))}; launches {tl}")
        if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
            fail("spliced training on phase B's ctc-data did not give "
                 "finite losses for its 2 steps")
        check_training_launches(tl, 2, 1, "spliced training on phase B")
        if not {"1/0/count", "1/2/count", "1/0/mu/rnn/0/w_hh",
                "1/0/nu/conv/0/w"} <= optim.keys() \
                or int(optim["1/0/count"]) != 2 * epochs:
            fail(f"optim_{epochs}.npz lacks the JAX package's keys or did "
                 "not resume the count")
    wall = time.perf_counter() - t_phase
    print(f"phase 8c wall time: {wall:.1f} s on {card}")


def drive_northstar(workroot: str, card: str):
    """Phase 8d: the paper's north-star chain A -> E through the port's
    north-star script (``tools/spliced_northstar.py::main``, the entry
    point a user runs) on the card at the flagship's width (``--features 768 --layers
    5``, ``--exp CPLX``), its depth cut by ``NS_ARGV``, with the launch
    counts set to 0 just before and read just after.  Fails unless every
    kernel of the chain launched, phase B wrote ctc-data with breakpoints
    for both kinds, phase D wrote a validation summary for each epoch of
    each seed and chose the epoch of the least ``err_only_ub`` (ties to the
    least ``err_far_ub``, as JAX does), phase E wrote the held-out test's
    summaries and ``northstar_summary.json`` holds JAX's keys."""
    import csv

    from xna_basecaller_tpu_torch.tools import spliced_northstar
    from xna_basecaller_tpu_torch.utils import native

    if not native.available():
        fail("the native library (native/xna_native.cpp) did not build: "
             "the chain would align and segment through the numpy "
             "fallbacks")
    out = os.path.join(workroot, "northstar")
    argv = ["--out", out, "--device", "cuda", "--exp", "CPLX",
            "--features", "768", "--layers", "5", *NS_ARGV]
    print(f"phase 8d, the north-star chain: python -m "
          f"xna_basecaller_tpu_torch.tools.spliced_northstar "
          f"{' '.join(argv)}", flush=True)
    wrappers = training_wrappers()
    zero_launches(wrappers)
    t0 = time.perf_counter()
    summary = spliced_northstar.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(wrappers)
    print(f"phase 8d launches {launches}")
    for k, n in launches.items():
        if n == 0:
            fail(f"{k} was not launched by the north-star chain")
    for kind in ("xna", "dna"):
        d = os.path.join(out, f"ctc_{kind}")
        if not os.path.exists(os.path.join(d, "breakpoints.npy")):
            fail(f"phase B wrote no {kind} ctc-data with breakpoints")
        n = len(np.load(os.path.join(d, "chunks.npy"), mmap_mode="r"))
        print(f"phase B {kind} ctc-data: {n} chunks")
    seeds = [25, 26]
    for seed in seeds:
        wd = os.path.join(out, f"spliced_model_s{seed}")
        errs = {}
        for e in range(1, NS_EPOCHS + 1):
            f = os.path.join(wd, f"basecalls-weights_{e}",
                             "results_summ-CPLX-val.csv")
            if not os.path.exists(f):
                fail(f"phase D wrote no validation summary for epoch {e} "
                     f"of seed {seed}")
            with open(f, newline="") as fh:
                row = next(csv.DictReader(fh))
            errs[e] = (float(row["err_only_ub"]), float(row["err_far_ub"]))
        chosen = int(os.readlink(os.path.join(wd, "weights_99.npz"))[8:-4])
        best = min(errs, key=lambda e: (errs[e][0], errs[e][1]))
        print(f"phase D seed {seed}: (err_only_ub, err_far_ub) by epoch "
              f"{errs}; chosen epoch {chosen}")
        if errs[chosen][0] != errs[best][0]:
            fail(f"phase D chose epoch {chosen} of seed {seed}, not the "
                 "least err_only_ub")
    with open(os.path.join(out, "northstar_summary.json")) as fh:
        written = json.load(fh)
    if list(written) != NS_SUMMARY_KEYS:
        fail(f"northstar_summary.json keys {list(written)} are not JAX's "
             f"{NS_SUMMARY_KEYS}")
    win = os.path.join(out, written["winner_dir"])
    for tag in ("test", "test-ind", "POC-test"):
        exp = "POC" if tag.startswith("POC") else "CPLX"
        split = tag.split("-", 1)[1] if exp == "POC" else tag
        f = os.path.join(win, f"basecalls-{tag}",
                         f"results_summ-{exp}-{split}.csv")
        if not os.path.exists(f):
            fail(f"phase E wrote no summary {f}")
    held = summary["test_heldout"]
    print(f"north-star result (held-out test, {held['num_aligned_reads']} "
          f"aligned reads): ub_acc {held.get('ub_acc')}, err_only_ub "
          f"{held.get('err_only_ub')}, read_acc {held.get('read_acc')}; "
          f"winner {written['best_seed']} epoch {written['best_epoch']}; "
          f"val err_only_ub by candidate {written['seed_candidates']}, "
          f"ensemble {written['ensemble_val_err_only_ub']}, soup "
          f"{written['soup_val_err_only_ub']}")
    print(f"phase 8d wall time: {wall:.1f} s on {card}")


SUPERBATCHES = (1, 2, 4)   # phase 4d: the pipeline's G, timed in turns
SUPERBATCH_TURNS = 3


def drive_superbatches(model, reads, fastq_one: str, cfg, n_batches: int,
                       card: str) -> dict:
    """Phase 4d: with the launch counts set to 0, ``run_basecaller``
    with ``superbatch=2`` over phase 4's reads: every read as
    ``superbatch=1`` called it, K1 5 times and K2a/b/c once per real
    batch (the trailing group's empty batches are not computed); then the
    pipeline's samples/s at each G of ``SUPERBATCHES`` over the same reads
    x4, in turns (the order reverses every round)."""
    from xna_basecaller_tpu_torch.infer.basecall import run_basecaller
    from xna_basecaller_tpu_torch.ops import crf_cuda, lstm_cuda

    bc = cfg.basecaller
    opts = dict(chunksize=bc.chunksize, overlap=bc.overlap,
                batchsize=bc.batchsize)
    wrappers = {"K1": lstm_cuda.lstm_recurrence,
                "K2a": crf_cuda.backward_scan,
                "K2b": crf_cuda.forward_viterbi,
                "K2c": crf_cuda.viterbi_traceback}
    zero_launches(wrappers)
    fq = io.StringIO()
    st = run_basecaller(model, iter(reads), fq, superbatch=2, **opts)
    launches = launch_counts(wrappers)
    need = {"K1": cfg.encoder.num_rnn_layers * n_batches, "K2a": n_batches,
            "K2b": n_batches, "K2c": n_batches}
    same = sum(a == b for a, b in zip(fq.getvalue().split("\n")[1::4],
                                      fastq_one.split("\n")[1::4]))
    print(f"superbatch 2 path: {st} launches {launches} (expected {need}; "
          f"{n_batches} batches in {math.ceil(n_batches / 2)} uploads); "
          f"{same} of {N_READS} reads called as superbatch 1 calls them "
          f"(tolerance: all)")
    if launches != need:
        fail("the superbatch path did not run K1 and K2a/b/c once per "
             "real batch")
    if fq.getvalue() != fastq_one:
        fail("superbatch 2 called the reads otherwise than superbatch 1")
    rates = {g: [] for g in SUPERBATCHES}
    for r in range(SUPERBATCH_TURNS):
        for g in SUPERBATCHES if r % 2 == 0 else SUPERBATCHES[::-1]:
            rates[g].append(run_basecaller(
                model, iter(reads * 4), io.StringIO(), superbatch=g,
                **opts)["samples_per_s"])
    print("pipeline by superbatch, same reads x4, in turns: " + "; ".join(
        f"G={g}: {[f'{v:.4e}' for v in vs]} samples/s (median "
        f"{statistics.median(vs):.4e})" for g, vs in rates.items())
        + f" on {card}")
    return launches


def drive_model_io(model, cfg, host_chunks: np.ndarray, card: str):
    """Phase 4e: the model's random weights written as a reference-format
    ``weights_1.tar`` (bonito's key names, ``export_state_dict``) beside
    its config.toml, and as ``weights_1.npz``; both loaded by
    ``load_model`` on the card (host-clock load times, in turns): the same
    weights, and one batch's labels bit-equal.  Then
    ``make_sharded_scorer(devices=[cuda:0])`` on the batch: labels
    bit-equal to ``basecall``'s (the model and the Viterbi decode of the
    f16 upload), and both timed in turns (host clock: upload, model,
    decode, fetch)."""
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.infer.basecall import _score_and_decode
    from xna_basecaller_tpu_torch.infer.sharded import make_sharded_scorer
    from xna_basecaller_tpu_torch.train.checkpoint import save_checkpoint
    from xna_basecaller_tpu_torch.utils.model_io import load_model
    from xna_basecaller_tpu_torch.utils.torch_import import (
        export_state_dict,
    )
    from xna_basecaller_tpu_torch.utils.weights import params_to_jax

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                        "chip_smoke_io")
    shutil.rmtree(root, ignore_errors=True)
    dev = next(model.parameters()).device
    nb, sl = cfg.n_base, cfg.state_len
    try:
        dirs = {k: os.path.join(root, k) for k in ("tar", "npz")}
        for d in dirs.values():
            os.makedirs(d)
            config_lib.save(cfg, d)
        torch.save(export_state_dict(model.state_dict()),
                   os.path.join(dirs["tar"], "weights_1.tar"))
        save_checkpoint(dirs["npz"], 1, params_to_jax(model.state_dict()))
        loads = {k: [] for k in dirs}
        for r in range(3):
            for k in ("tar", "npz") if r % 2 == 0 else ("npz", "tar"):
                t0 = time.perf_counter()
                loaded, _ = load_model(dirs[k], device="cuda")
                torch.cuda.synchronize()
                loads[k].append((time.perf_counter() - t0) * 1e3)
                if k == "tar":
                    m_tar = loaded
                else:
                    m_npz = loaded
        sizes = {k: os.path.getsize(os.path.join(d, f"weights_1.{k}"))
                 for k, d in dirs.items()}
        print("load_model of the flagship, in turns (ms, host clock): "
              + "; ".join(f"weights_1.{k} ({sizes[k] / 1e6:.1f} MB) "
                          f"{[round(v, 1) for v in vs]}"
                          for k, vs in loads.items()) + f" on {card}")
        a, b = m_tar.state_dict(), m_npz.state_dict()
        if sorted(a) != sorted(b) or not all(torch.equal(a[k], b[k])
                                             for k in a):
            fail("the tar-loaded weights differ from the npz-loaded ones")
        x = torch.from_numpy(host_chunks.astype(np.float16)).to(dev)
        with torch.inference_mode():
            lab = {k: _score_and_decode(m(x), nb, sl)
                   for k, m in (("tar", m_tar), ("npz", m_npz),
                                ("model", model))}
        n_diff = int((lab["tar"] != lab["npz"]).sum())
        print(f"labels of one batch, tar-loaded against npz-loaded model: "
              f"{n_diff} frames differ (tolerance 0)")
        if n_diff:
            fail("the tar-loaded model labels the batch otherwise")
        del m_tar, m_npz, a, b
        scorer = make_sharded_scorer(model, [torch.device("cuda", 0)])
        paths = scorer(host_chunks)
        n_diff = int((torch.from_numpy(paths) != lab["model"].cpu()).sum())
        print(f"sharded scorer [cuda:0] against basecall's batch: {n_diff} "
              f"label frames differ (tolerance 0)")
        if n_diff:
            fail("the sharded scorer labels the batch otherwise than "
                 "basecall")
        host_f16 = host_chunks.astype(np.float16)

        def basecall_batch():
            with torch.inference_mode():
                return _score_and_decode(model(torch.from_numpy(
                    host_f16).to(dev)), nb, sl).cpu()
        t = host_turns({"sharded scorer [cuda:0]": lambda: scorer(
            host_chunks), "basecall's batch": basecall_batch}, reps=7)
        print("one batch of 256 x 3600, medians of 7 in turns (host clock, "
              "upload to labels on the host): " + ", ".join(
                  f"{k} {v:.2f} ms" for k, v in t.items()) + f" on {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def host_turns(fns: dict, reps: int = 21, burst: int = 1) -> dict:
    """Median host-clock time (ms) of each function over ``reps`` samples
    taken in turns as ``in_turns`` takes them, for work that waits on the
    host (a numpy round trip): a sample is ``burst`` calls back to back,
    then a synchronize, over ``burst``."""
    names = list(fns)
    for n in names:
        fns[n]()
    torch.cuda.synchronize()
    times = {n: [] for n in names}
    for r in range(reps):
        for n in names if r % 2 == 0 else names[::-1]:
            t0 = time.perf_counter()
            for _ in range(burst):
                fns[n]()
            torch.cuda.synchronize()
            times[n].append((time.perf_counter() - t0) * 1e3 / burst)
    return {n: statistics.median(v) for n, v in times.items()}


def time_augmentation(model, sim, tables, card):
    """Phase 9 (augmentation), on phase 5's training batch (64 x 3600,
    breakpoints from the simulator): ``spike_batch`` and ``stitch_batch``
    (relaxed, as phase 8b runs it) alone with the flagship's defaults, and
    the pick loop alone, by CUDA events, and the card's share of one call
    of each (a ``torch.profiler`` trace); the closures with their numpy
    round trip beside the two functions on the card's tensors, by the host
    clock, medians of 21 in turns; the training step as the ``Trainer``
    runs it with and without both augmentations (as phase 8b runs them),
    by the host clock."""
    import csv

    from xna_basecaller_tpu_torch.augment import spike, stitch
    from xna_basecaller_tpu_torch.data.ctc_data import ChunkDataset
    from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
    from xna_basecaller_tpu_torch.train.loop import Trainer

    dev = torch.device("cuda")
    host = [np.ascontiguousarray(a, dt) for a, dt in zip(
        sim, (np.float32, np.int32, np.int32, np.int32))]
    batch = [torch.from_numpy(a).to(dev) for a in host]
    pore = load_pore_model()
    kmer = [torch.from_numpy(a).to(dev) for a in (pore.means, pore.stds)]
    tbl = [torch.from_numpy(a).to(dev) for a in (
        tables.signals, tables.lens, tables.counts)]
    fallback = torch.from_numpy(
        stitch.build_relax_fallback(tables.counts)).long().to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lengths = batch[2].long()
    n_pos = spike._n_positions(batch[2], 0.10, 0, 64)
    no_ub = torch.zeros(batch[1].shape, dtype=torch.bool, device=dev)
    with torch.no_grad():
        t_dev = in_turns({
            "spike_batch": lambda: spike.spike_batch(gen, *batch, *kmer),
            "stitch_batch (relaxed)": lambda: stitch.stitch_batch(
                gen, *batch, *tbl, tbl_fallback=fallback),
            "the pick loop alone (_choose_positions, 64 rounds)":
                lambda: spike._choose_positions(gen, lengths, n_pos, 64, 5,
                                                no_ub),
        })
    aug_stitch = stitch.make_stitch_augment(None, tables=tables, relax=True,
                                            device=dev)
    aug_spike = spike.make_spike_augment(prop_ubs=0.05, device=dev)
    rng = np.random.default_rng(SEED)
    c, t, l, b = host
    # each closure beside its function on tensors already on the card: the
    # difference is the numpy round trip (upload, download, the wait)
    with torch.no_grad():
        t_host = host_turns({
            "stitch_batch (relaxed)": lambda: stitch.stitch_batch(
                gen, *batch, *tbl, tbl_fallback=fallback),
            "stitch closure (relaxed; numpy in, numpy out)":
                lambda: aug_stitch(c, t, l, b, rng),
            "spike_batch (prop 0.05)": lambda: spike.spike_batch(
                gen, *batch, *kmer, prop_ubs=0.05),
            "spike closure (prop 0.05; numpy in, numpy out)":
                lambda: aug_spike(c, t, l, b, rng),
        })

    def both(cc, tt, ll, bb, rng):
        cc, tt = aug_stitch(cc, tt, ll, bb, rng)
        return aug_spike(cc, tt, ll, bb, rng)

    # the step as the Trainer runs it (the next batch made in a background
    # thread on a stream of its own): the median spacing of the steps in
    # losses_1.csv, epochs of 8 steps over the same 64 chunks, plain and
    # augmented in turns (plain, augmented, augmented, plain)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                        "chip_smoke_epoch")
    tiled = [np.concatenate([a] * 8) for a in host]
    plain, augmented = "train step", "train step with stitch + spike"
    spacing = {plain: [], augmented: []}
    for name in (plain, augmented, augmented, plain):
        shutil.rmtree(work, ignore_errors=True)
        Trainer(model, ChunkDataset(
                    *tiled, augment=both if name == augmented else None),
                ChunkDataset(*(a[:1] for a in host)),
                batchsize=TRAIN_BATCH, log=lambda *a: None).fit(work)
        with open(os.path.join(work, "losses_1.csv")) as fh:
            times = [float(r["time"]) for r in csv.DictReader(fh)]
        spacing[name] += list(np.diff(times) * 1e3)
    shutil.rmtree(work, ignore_errors=True)
    t_step = {k: statistics.median(v) for k, v in spacing.items()}
    print("time augmentation at 64 x 3600 (CUDA events, medians of 21 in "
          "turns): " + ", ".join(f"{k} {v:.3f} ms" for k, v in t_dev.items())
          + f" on {card}")
    print("time augmentation functions and closures (host clock, medians of "
          "21 in turns): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in t_host.items())
          + "; training step as the Trainer runs it (host clock, medians "
          "of 14 step spacings, epochs in turns): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in t_step.items())
          + f" on {card}")
    # the card's share of each: one call traced, its kernels over its span
    # (the profiler slows the host's side, not the kernels; it comes after
    # the host-clock times above, so that none of them follows these traces)
    from torch.profiler import ProfilerActivity, profile, record_function

    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                         "chip_smoke_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    shares = {}
    for name, fn in (("spike_batch", lambda: spike.spike_batch(
            gen, *batch, *kmer)), ("stitch_batch", lambda: stitch.stitch_batch(
                gen, *batch, *tbl, tbl_fallback=fallback)),
            ("the pick loop", lambda: spike._choose_positions(
                gen, lengths, n_pos, 64, 5, no_ub))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(name):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        shares[name] = busy_share(trace, span=name)
    os.remove(trace)
    print("card inside the augmentation (one call traced by torch.profiler): "
          + ", ".join(f"{k} {v[3]} kernels, {v[2]:.3f} ms of kernels over "
                      f"{v[1]:.3f} ms" if v else f"{k} not measured"
                      for k, v in shares.items()) + f" on {card}")
    gap = t_step[augmented] - t_step[plain]
    print(f"augmentation's cost in the step: {gap:.3f} ms "
          f"({gap / t_step[augmented]:.1%} of the augmented step) on {card}")


def lstm_yardsticks(model, keep, k1_inputs, xb, xf, card, baseline):
    """Phase 9 (LSTM kernels): K1, K3a and K3b each beside the port's
    like-for-like layer and its cuDNN yardstick (``torch.nn.LSTM`` with
    flattened weights, layer 0's weights), as medians of 21 calls taken in
    turns in one stretch: K1 at the basecall batch (and the baseline
    tree's K1, when given), K3a and K3b at the training batch; K1's f32
    route on the first DUPLEX_K1_ROWS[0] rows of the f32 layer input
    ``xf`` (duplex's chunks of a read) beside the port's f32 projection +
    K1 and cuDNN's f32 ``nn.LSTM`` (TF32 off for cuDNN and for matrix
    products; the baseline tree's f32 K1 when given); and each plain
    version once.  Returns {kernel: (ms, plain ms, library ms)}."""
    from xna_basecaller_tpu_torch.ops import lstm, lstm_cuda

    xp3, w3, dys, ys3, cs3, rev = keep
    xp1, w1 = k1_inputs
    T, N, H = ys3.shape
    p = model.rnn[0].params(torch.bfloat16)

    def cudnn_lstm(train: bool):
        ref = torch.nn.LSTM(H, H).to("cuda", torch.bfloat16).train(train)
        with torch.no_grad():
            ref.weight_ih_l0.copy_(p["w_ih"].T)
            ref.weight_hh_l0.copy_(p["w_hh"].T)
            ref.bias_ih_l0.copy_(p["bias"])
            ref.bias_hh_l0.zero_()
        ref.flatten_parameters()
        return ref

    ref = cudnn_lstm(False)
    with warnings.catch_warnings(record=True) as caught, \
            torch.inference_mode():
        warnings.simplefilter("always")
        ref(xb)
    print(f"warnings of one cuDNN call after flatten_parameters: "
          f"{[str(w.message)[:120] for w in caught]}")
    # in bf16 cuDNN still warns on every call that the weights are not one
    # chunk, after flatten_parameters too
    warnings.filterwarnings("ignore", message="RNN module weights")
    with torch.inference_mode():
        fns = {"K1": lambda: lstm_cuda.lstm_recurrence(xp1, w1),
               "projection + K1": lambda: lstm_cuda.lstm_forward(p, xb),
               "nn.LSTM inference": lambda: ref(xb)}
        if baseline:
            fns["K1 of the baseline tree"] = lambda: baseline["K1"](xp1, w1)
        inf = in_turns(fns)
        k1_plain = elapsed_ms(lambda: lstm.lstm_recurrence(xp1, w1), 1)
    ref_t = cudnn_lstm(True)
    x = torch.randn(T, N, H, device="cuda", dtype=torch.bfloat16,
                    generator=torch.Generator("cuda").manual_seed(SEED))
    x.requires_grad_()
    with torch.no_grad():
        k3a = lambda: lstm_cuda.lstm_forward_with_cells(xp3, w3, rev)  # noqa: E731
        k3b = lambda: lstm_cuda.lstm_backward_dxp(  # noqa: E731
            dys, xp3, w3, ys3, cs3, rev)
        k3a_plain = elapsed_ms(
            lambda: lstm.lstm_recurrence_with_cells(xp3, w3, rev), 1)
        k3b_plain = elapsed_ms(
            lambda: lstm.lstm_backward_dxp(dys, xp3, w3, ys3, cs3, rev), 1)
    fwd = in_turns({
        "K3a": k3a,
        "projection + K3a": lambda: lstm_cuda.lstm_forward_trainable(
            p, x, rev),
        "nn.LSTM training forward": lambda: ref_t(x)})
    out_p = lstm_cuda.lstm_forward_trainable(p, x, rev)
    out_r, _ = ref_t(x)
    bwd = in_turns({
        "K3b": k3b,
        "K3b + dW + projection backward": lambda: out_p.backward(
            dys, retain_graph=True),
        "nn.LSTM backward": lambda: out_r.backward(dys, retain_graph=True)})
    del out_p, out_r
    model.zero_grad(set_to_none=True)
    # K1's f32 route at duplex's shape, beside cuDNN's f32 LSTM
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p32 = model.rnn[0].params(torch.float32)
    n32 = DUPLEX_K1_ROWS[0]
    x32 = xf[:, :n32].float().contiguous()
    ref32 = torch.nn.LSTM(H, H).to("cuda").eval()
    with torch.no_grad():
        ref32.weight_ih_l0.copy_(p32["w_ih"].T)
        ref32.weight_hh_l0.copy_(p32["w_hh"].T)
        ref32.bias_ih_l0.copy_(p32["bias"])
        ref32.bias_hh_l0.zero_()
    ref32.flatten_parameters()
    with torch.inference_mode():
        xp32 = lstm.input_projection(p32, x32)
        fns = {"K1 f32": lambda: lstm_cuda.lstm_recurrence(xp32,
                                                           p32["w_hh"]),
               "projection + K1 f32": lambda: lstm_cuda.lstm_forward(p32,
                                                                     x32),
               "nn.LSTM f32 inference": lambda: ref32(x32)}
        if baseline:
            fns["K1 f32 of the baseline tree"] = lambda: baseline["K1"](
                xp32, p32["w_hh"])
        f32 = in_turns(fns)
        k1f_plain = elapsed_ms(
            lambda: lstm.lstm_recurrence(xp32, p32["w_hh"]), 1)
    print(f"f32 yardstick: torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    for what, got in (("K1 at the basecall batch", inf),
                      ("K3a at the training batch", fwd),
                      ("K3b at the training batch", bwd),
                      (f"K1 f32 at duplex's {n32} rows", f32)):
        print(f"time {what}, medians of 21 in turns: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in got.items()) + f" on {card}")
    return {"K1": (inf["K1"], k1_plain, inf["nn.LSTM inference"]),
            "K3a": (fwd["K3a"], k3a_plain, fwd["nn.LSTM training forward"]),
            "K3b": (bwd["K3b"], k3b_plain, bwd["nn.LSTM backward"]),
            "K1-f32": (f32["K1 f32"], k1f_plain,
                       f32["nn.LSTM f32 inference"])}


def rows_sweep(card):
    """Phase 9: where each step's time goes.  K1, K3a, K3b and K7 at T=720,
    H=768, bf16 (random inputs from the seed) for N in 16, 32, 64 (K1, K3a,
    K3b: the clustered launch of at most 64 rows) and 128 (K1 and K7 also
    192 and 256: one launch of the rows kernel, of one or two 128-row
    tiles; two clustered launches for K3b), and K1's f32 route at the
    F32_SWEEP_ROWS, each the median of 5 calls.
    The time per step and launch, fitted as a + b x rows over N <= 64 and,
    for K1 and K7, over 128-256 rows, splits a fixed cost per step from
    the cost of the rows."""
    from xna_basecaller_tpu_torch.ops import lstm, lstm_cuda

    T, H = 720, 768
    g = torch.Generator("cuda").manual_seed(SEED)
    w = (torch.randn(H, 4 * H, device="cuda", generator=g)
         / H ** 0.5).to(torch.bfloat16)
    w32 = w.float()
    w_q, scale = lstm.quantize_w_hh(w)
    for name, wrapper, sizes in (
            ("K1", lstm_cuda.lstm_recurrence, (16, 32, 64, 128, 192, 256)),
            ("K3a", lstm_cuda.lstm_forward_with_cells, (16, 32, 64, 128)),
            ("K3b", lstm_cuda.lstm_backward_dxp, (16, 32, 64, 128)),
            ("K7", lstm_cuda.lstm_recurrence_int8,
             (16, 32, 64, 128, 192, 256)),
            ("K1 f32", lstm_cuda.lstm_recurrence, F32_SWEEP_ROWS)):
        dtype = torch.float32 if name == "K1 f32" else torch.bfloat16
        points = []
        for N in sizes:
            xp = torch.randn(T, N, 4 * H, device="cuda", generator=g).to(
                dtype)
            with torch.no_grad():
                if name == "K3b":
                    ys, cs = lstm_cuda.lstm_forward_with_cells(xp, w)
                    dys = (torch.randn(T, N, H, device="cuda", generator=g)
                           * 1e-2).to(torch.bfloat16)
                    fn = lambda: wrapper(dys, xp, w, ys, cs)  # noqa: E731
                elif name == "K7":
                    fn = lambda: wrapper(xp, w_q, scale)  # noqa: E731
                else:
                    fn = lambda: wrapper(  # noqa: E731
                        xp, w32 if dtype == torch.float32 else w)
                before = _build.launches[wrapper.__name__]
                fn()
                launches = _build.launches[wrapper.__name__] - before
                ms = median_ms(fn, 5)
            rows = -(-N // launches)
            points.append((N, rows, launches, ms, ms / (T * launches) * 1e3))
        fits = []
        for what, pts in (("N <= 64", [q for q in points if q[0] <= 64]),
                          ("128-256 rows", [q for q in points
                                            if q[0] >= 128 and q[2] == 1])):
            if len(pts) >= 2:
                b, a = np.polyfit([q[1] for q in pts], [q[4] for q in pts], 1)
                fits.append(f"fit per step at {what} = {a:.2f} us + "
                            f"{b * 1e3:.2f} ns x rows")
        print(f"rows sweep {name} (T={T}, H={H}, "
              f"{'f32' if dtype == torch.float32 else 'bf16'}): " + "; ".join(
            f"N={n}: {ms:.3f} ms, {launches} launch(es) of {rows} rows, "
            f"{us:.2f} us per step" for n, rows, launches, ms, us in points)
            + "; " + "; ".join(fits) + f" on {card}")


def crf_scan_turns(scores, train_scores, lattice, nb, sl, card, baseline):
    """Phase 9 (the CRF kernels): K2a at the basecall batch, K5a (K2a's
    kernel) and K4 at the training batch, K2b and K2c at the basecall
    batch and at the validation batch's 16 rows, then the lattice's K6a at
    the training batch and at the validation batch's 16 rows and K6b at
    the training batch, on stay and move packed as the loss packs them,
    each the median of 21 samples of SCAN_BURST calls back to back (the
    wrapper's host time would show in a call timed alone: these kernels
    take well under a millisecond); with ``--baseline``, taken in turns
    with the baseline tree's kernel (on the lattice as that tree lays it
    out) after checking that betas, alphas, logZ, bp, v_final, labels,
    d_stay and d_move are bit-equal to its; the decode chain
    (``decode_paths_cuda``) at the basecall batch by the same statistic,
    in turns with the baseline tree's K2a, logZ, K2b and K2c; and each
    plain version once.  Returns {kernel: (ms, plain ms)} at the basecall
    batch (K2a, K2b, K2c) and the training batch (the others)."""
    from xna_basecaller_tpu_torch.ops import crf, crf_cuda

    def turns(k, T, shape, fns, outputs):
        if baseline:
            got, want = (f() for f in fns.values())
            got, want = ((g,) if torch.is_tensor(g) else g
                         for g in (got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"{k} ({shape}) against the baseline tree's kernel: "
                  f"{'bit-equal' if same else 'DIFFERENT'} ({outputs})")
            if not same:
                fail(f"{k} is not bit-equal to the baseline tree's kernel")
        t = in_turns(fns, burst=SCAN_BURST)
        print(f"time {k} ({shape}), medians of 21 samples of "
              f"{SCAN_BURST} calls" + (" in turns" if baseline else "")
              + ": " + ", ".join(
                  f"{n} {v:.3f} ms ({v / T * 1e3:.3f} us a step)"
                  for n, v in t.items()) + f" on {card}")
        return t[k]

    out = {}
    for k, sc in (("K2a", scores), ("K5a", train_scores),
                  ("K4", train_scores)):
        T, N = sc.shape[:2]
        scan = crf_cuda.forward_scan if k == "K4" else crf_cuda.backward_scan
        fns = {k: lambda scan=scan, sc=sc: scan(sc, nb, sl)}
        if baseline:
            theirs = baseline["K4" if k == "K4" else "K2a"]
            fns[f"{k} of the baseline tree"] = \
                lambda theirs=theirs, sc=sc: theirs(sc, nb, sl)
        ms = turns(k, T, f"T={T}, N={N}", fns,
                   "alphas, logZ" if k == "K4" else "betas")
        plain = crf.forward_scores if k == "K4" else crf.backward_scores
        out[k] = (ms, elapsed_ms(lambda: plain(sc, nb, sl), 1))

    T, N = scores.shape[:2]
    for rows in (N, 16):
        sc = scores if rows == N else scores[:, :rows].contiguous()
        betas = crf_cuda.backward_scan(sc, nb, sl)
        logz = crf.logz_from_betas(betas)
        bp, v_final = crf_cuda.forward_viterbi(sc, betas, logz, nb, sl)
        fns = {"K2b": lambda: crf_cuda.forward_viterbi(sc, betas, logz, nb,
                                                       sl)}
        if baseline:
            fns["K2b of the baseline tree"] = lambda: baseline["K2b"](
                sc, betas, logz, nb, sl)
        ms_b = turns("K2b", T, f"T={T}, N={rows}", fns, "bp, v_final")
        fns = {"K2c": lambda: crf_cuda.viterbi_traceback(bp, v_final, nb,
                                                         sl)}
        if baseline:
            fns["K2c of the baseline tree"] = lambda: baseline["K2c"](
                bp, v_final, nb, sl)
        ms_c = turns("K2c", T, f"T={T}, N={rows}", fns, "labels")
        if rows == N:
            out["K2b"] = (ms_b, elapsed_ms(lambda: crf.forward_viterbi(
                sc, betas, logz, nb, sl), 1))
            out["K2c"] = (ms_c, elapsed_ms(lambda: crf.viterbi_traceback(
                bp, v_final, nb, sl), 1))
    fns = {"decode": lambda: crf_cuda.decode_paths_cuda(scores, nb, sl)}
    if baseline:
        def theirs():
            betas = baseline["K2a"](scores, nb, sl)
            bp, v_final = baseline["K2b"](scores, betas,
                                          crf.logz_from_betas(betas), nb, sl)
            return baseline["K2c"](bp, v_final, nb, sl)
        fns["decode of the baseline tree"] = theirs
    turns("decode", T, f"K2a + logZ + K2b + K2c, T={T}, N={N}", fns,
          "labels")

    stay, move, lengths, _, _, ct = lattice
    lengths = lengths.to(torch.int32)
    T, N, n = stay.shape
    for k, rows in (("K6a", N), ("K6a", 16), ("K6b", N)):
        # the lattice as the loss hands it to the kernels: packed views
        s, m = crf_cuda.lattice_unpack(crf_cuda.lattice_pack(
            stay[:, :rows], move[:, :rows]), n)
        ln, c = lengths[:rows], ct[:rows]
        alphas, logz = crf_cuda.lattice_forward(s, m, ln)
        if k == "K6a":
            fns = {k: lambda s=s, m=m, ln=ln: crf_cuda.lattice_forward(
                s, m, ln)}
        else:
            fns = {k: lambda: crf_cuda.lattice_backward(s, m, ln, alphas,
                                                        logz, c)}
        if baseline:
            lat = baseline["lattice"]
            ins = lat["inputs"](s, m)
            a_b = lat["K6a"](ins, ln)[0]   # in that tree's layout
            fns[f"{k} of the baseline tree"] = (
                (lambda ins=ins, ln=ln: lat["K6a"](ins, ln)) if k == "K6a"
                else (lambda: lat["K6b"](ins, ln, a_b, logz, c)))
        ms = turns(k, T, f"T={T}, N={rows}, n={n}", fns,
                   "alphas, logZ" if k == "K6a" else "d_stay, d_move")
        if rows == N:
            plain = crf.lattice_forward if k == "K6a" else (
                lambda s, m, ln: crf.lattice_backward(s, m, ln, alphas,
                                                      logz, c))
            out[k] = (ms, elapsed_ms(lambda: plain(s, m, ln), 1))
    return out


def time_decoders(model, batch, scores, betas, logz, dec_inputs, nb, sl,
                  card, baseline):
    """Phase 9 (the q-score and beam decoders) at the basecall batch, as
    medians of 21 samples of SCAN_BURST calls taken in turns: the decode
    chains (Viterbi, q-score, beam at each width of BEAM_TIMED) and K4 at
    256 rows; the q-score K2b and K2c in turns with the Viterbi ones; the
    beam kernel alone at each width (with ``--baseline``, in turns with
    that tree's, held bit-equal to it); each plain version once; one batch
    through the model and each decode (CUDA events, 3 calls); the host's
    q-string of 256 chunks of QUAL_BASES bases, per base as JAX's loop
    and vectorised (host clock, medians of 3).  Returns {kernel: (ms,
    plain ms)} for the q-score K2b and K2c and the beam kernel (at
    PIPELINE_BEAM)."""
    from xna_basecaller_tpu_torch.data.writers import phred, qstring
    from xna_basecaller_tpu_torch.ops import crf, crf_cuda

    bp_q, v_q, edge_sel, parts = dec_inputs
    T, N = scores.shape[:2]
    chains = {"Viterbi (K2a, logZ, K2b, K2c)":
              lambda: crf_cuda.decode_paths_cuda(scores, nb, sl),
              "q-score (K2a, logZ, K2b-qual, K2c-qual)":
              lambda: crf_cuda.decode_paths_with_qual_cuda(scores, nb, sl)}
    for B in BEAM_TIMED:
        chains[f"beam {B} (K4, K2a, beam)"] = \
            lambda B=B: crf_cuda.decode_beam_cuda(scores, nb, sl, B)
    chains["K4 alone"] = lambda: crf_cuda.forward_scan(scores, nb, sl)
    t = in_turns(chains, burst=SCAN_BURST)
    print(f"time the decode chains at T={T}, N={N}, medians of 21 samples "
          f"of {SCAN_BURST} calls in turns: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in t.items()) + f" on {card}")
    out = {}
    for k, fns in (
            ("K2b-qual", {"K2b-qual": lambda: crf_cuda.forward_viterbi_qual(
                scores, betas, logz, nb, sl),
                "K2b": lambda: crf_cuda.forward_viterbi(
                    scores, betas, logz, nb, sl)}),
            ("K2c-qual", {"K2c-qual": lambda: crf_cuda.viterbi_traceback_qual(
                bp_q, v_q, edge_sel, nb, sl),
                "K2c": lambda: crf_cuda.viterbi_traceback(bp_q, v_q, nb,
                                                          sl)})):
        tt = in_turns(fns, burst=SCAN_BURST)
        print(f"time {k} in turns with the Viterbi kernel (T={T}, N={N}), "
              f"medians of 21 samples of {SCAN_BURST} calls: " + ", ".join(
                  f"{n} {v:.3f} ms ({v / T * 1e3:.3f} us a step)"
                  for n, v in tt.items()) + f" on {card}")
        out[k] = tt[k]
    fns = {}
    for B in BEAM_TIMED:
        fns[B] = lambda B=B: crf_cuda.beam_search(scores, *parts, nb, sl, B)
        if baseline and "beam" in baseline:
            theirs = lambda B=B: baseline["beam"](scores, *parts, nb, sl, B)
            same = all(torch.equal(a, b) for a, b in zip(fns[B](), theirs()))
            print(f"beam kernel B={B} against the baseline tree's: labels "
                  f"and best_score bit-equal: {same}")
            if not same:
                fail("the beam kernel is not bit-equal to the baseline "
                     "tree's")
            fns[f"{B} of the baseline tree"] = theirs
    beams = in_turns(fns, burst=SCAN_BURST)
    print(f"time the beam kernel alone (T={T}, N={N}), medians of 21 "
          f"samples of {SCAN_BURST} calls in turns: " + ", ".join(
              f"B={B} {v:.3f} ms ({v / T * 1e3:.3f} us a step)"
              for B, v in beams.items()) + f" on {card}")
    plain = {
        "K2b-qual": elapsed_ms(lambda: crf.forward_viterbi(
            scores, betas, logz, nb, sl, qual=True), 1),
        "K2c-qual": elapsed_ms(lambda: crf.viterbi_traceback(
            bp_q, v_q, nb, sl, edge_sel), 1),
        "beam": elapsed_ms(lambda: crf.beam_search(
            scores, *parts, nb, sl, PIPELINE_BEAM), 1)}
    print(f"time the plain versions once: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in plain.items())
        + f" (beam at B={PIPELINE_BEAM}) on {card}")

    batches = {
        "model + Viterbi": lambda: crf_cuda.decode_paths_cuda(
            model(batch), nb, sl),
        "model + q-score decode": lambda: crf_cuda.decode_paths_with_qual_cuda(
            model(batch), nb, sl),
        f"model + beam {PIPELINE_BEAM}": lambda: crf_cuda.decode_beam_cuda(
            model(batch), nb, sl, PIPELINE_BEAM)}
    print("time one batch through the model and each decode (mean of 3): "
          + ", ".join(f"{k} {elapsed_ms(fn, 3):.3f} ms"
                      for k, fn in batches.items()) + f" on {card}")

    # the host's q-string: the stitched probabilities of 256 chunk-reads
    probs = crf_cuda.decode_paths_with_qual_cuda(scores, nb, sl)[1].half()
    probs = probs.float().cpu().numpy()
    rng = np.random.default_rng(SEED)
    per_chunk = [probs[i % N][rng.integers(0, T, QUAL_BASES)]
                 for i in range(256)]
    loop, vec = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        a = ["".join(phred(p) for p in c) for c in per_chunk]
        t1 = time.perf_counter()
        b = [qstring(c) for c in per_chunk]
        t2 = time.perf_counter()
        loop.append(t1 - t0)
        vec.append(t2 - t1)
        if a != b:
            fail("the vectorised q-string differs from the phred loop")
    print(f"host q-string of 256 chunks x {QUAL_BASES} bases (host clock, "
          f"medians of 3): per-base phred loop "
          f"{statistics.median(loop) * 1e3:.2f} ms, vectorised "
          f"{statistics.median(vec) * 1e3:.3f} ms, equal strings")
    return {k: (out.get(k, beams[PIPELINE_BEAM]), plain[k])
            for k in ("K2b-qual", "K2c-qual", "beam")}


def time_training(model, batch, loss_keep, card):
    """Phase 9 (training side): the loss kernel K5b (as ``crf_ms``) with
    its plain version (no PyTorch call computes this function), one
    training step with its breakdown, and the step with and without the
    data-parallel all-reduces (an NCCL group of one rank) in turns."""
    from xna_basecaller_tpu_torch.ops import crf, crf_cuda
    from xna_basecaller_tpu_torch.train.loop import (
        make_optimizer, train_step,
    )

    t = {}
    with torch.no_grad():
        sc, alphas, betas, logz, ct = loss_keep[:5]
        nb, sl = model.cfg.n_base, model.cfg.state_len
        t["K5b"] = (
            crf_ms(lambda: crf_cuda.edge_posteriors(
                sc, alphas, betas, logz, ct)),
            elapsed_ms(lambda: crf.edge_posteriors(
                sc, alphas, betas, logz, ct), 3))
    chunks, targets, lengths = batch

    # one training step and its parts
    opt = make_optimizer(model, lambda _: 5e-4)
    state_len = model.cfg.state_len

    def masked_loss(scores):
        per = model.loss(scores, targets, lengths.clamp(min=state_len + 1),
                         reduction="none")
        valid = (lengths > 0).float()
        return (per * valid).sum() / valid.sum().clamp(min=1.0)

    def step():
        train_step(model, opt, chunks, targets, lengths)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) / 5 * 1e3
    # the same step with the data-parallel all-reduces (the valid counts,
    # then one flat bucket of the gradients and the loss), in an NCCL
    # group of one rank joined by this process; in turns with the plain
    # step, host clock
    import socket

    from xna_basecaller_tpu_torch.parallel import distributed
    from xna_basecaller_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    distributed.initialize(f"localhost:{port}", 1, 0, device="cuda")
    try:
        mesh = make_mesh(chunks.device)
        dp = host_turns({
            "train step": step,
            "train step with the all-reduces (NCCL, world size 1)":
                lambda: train_step(model, opt, chunks, targets, lengths,
                                   mesh=mesh)}, reps=11)
    finally:
        distributed.shutdown()
    print("train step with and without data parallelism, medians of 11 in "
          "turns (host clock): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in dp.items()) + f" on {card}")
    fwd = lambda: model(chunks, inference=False)  # noqa: E731
    scores = fwd().detach().requires_grad_()
    masked_loss(scores).backward()
    g_scores = scores.grad
    t_fwd = elapsed_ms(fwd, 3)
    t_fwd_bwd = elapsed_ms(lambda: fwd().backward(g_scores), 3)

    def loss_fwd_bwd():
        masked_loss(scores).backward()
    t_loss = elapsed_ms(loss_fwd_bwd, 3)
    t_opt = elapsed_ms(opt.step, 5)
    n_samples = chunks.shape[0] * chunks.shape[1]
    parts = {"model forward (conv, 5 x (projection + K3a), head)": t_fwd,
             "loss forward + backward (K4, K6a; K6b, K5a, K5b; torch "
             "glue)": t_loss,
             "model backward (head, 5 x (K3b + dW + projection backward), "
             "conv)": t_fwd_bwd - t_fwd,
             "optimizer (clip + AdamW)": t_opt}
    for k, v in t.items():
        print(f"time {k} (ms, plain ms): {v} ms on {card}")
    print(f"train step: {t_step:.3f} ms (host clock, 5 steps) on {card}; "
          "parts by CUDA events: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in parts.items())
          + f", sum {sum(parts.values()):.3f} ms")
    print(f"training: {n_samples / t_step * 1e3:.4e} samples/s "
          f"({chunks.shape[0]} x {chunks.shape[1]} per step) on {card}")
    return t


# phase 8f: the CTC family's training run: phase 8's ctc-data (528 chunks)
# leaves 512 training chunks (8 steps of 64) and 16 validation chunks; the
# warmup starts at a tenth of --lr, so 2e-3 moves the weights in 8 steps
CTC_BATCH, CTC_LR, CTC_CPU_CHUNKS = 64, "2e-3", 4
# phase 8g: the mods classifier's synthetic sites and the reads it calls
MODS_SITES, MODS_TRAIN, MODS_READS, MODS_LEN = 8192, 6144, 8, 16_000
# phase 8h: simulated template/complement pairs of one sequence each; the
# least simplex identity of a complement's call, and the least median
# identity of the joint calls (%)
DUPLEX_PAIRS, DUPLEX_BASES = 8, 2500
DUPLEX_SIMPLEX_MIN, DUPLEX_JOINT_MIN = 95.0, 90.0
# phase 8i: evaluate's chunks of phase 8's ctc-data and its batch
EVAL_CHUNKS, EVAL_BATCH = 128, 64


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` (the card waited for), after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def drive_ctc_family(workroot: str, reads, card: str):
    """Phase 8f: the legacy QuartzNet CTC family at full width
    (``quartznet5x5_config("NACGTXY")``: filters 256-1024, kernels 33-87,
    C1 stride 3; random weights from SEED) on the card: ``basecall_ctc``
    over phase 4's reads, greedy and beam 5; the card's log-probs of
    CTC_CPU_CHUNKS chunks held to the port's CPU run of the same chunks;
    ``train --config <quartznet toml>`` for 8 steps of 64 on phase 8's
    ctc-data (the loss finite and falling, the batchnorm running stats
    moved); each stage's time."""
    import csv

    from xna_basecaller_tpu_torch.cli import main as cli
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.data import chunkops
    from xna_basecaller_tpu_torch.data.ctc_data import load_datasets
    from xna_basecaller_tpu_torch.infer.ctc_basecall import (
        basecall_ctc, forward_f16,
    )
    from xna_basecaller_tpu_torch.models.ctc_model import (
        CtcModel, masked_ctc_loss, merge_bn_stats, quartznet5x5_config,
    )
    from xna_basecaller_tpu_torch.ops import ctc as ctc_ops
    from xna_basecaller_tpu_torch.ops.conv import ACTIVATIONS
    from xna_basecaller_tpu_torch.train.loop import make_optimizer
    from xna_basecaller_tpu_torch.utils.model_io import load_model

    t_phase = time.perf_counter()
    cfg = quartznet5x5_config("NACGTXY")
    model = CtcModel(cfg, device="cuda", seed=SEED)
    chunks = np.concatenate([chunkops.chunk(r.signal, 3600, 500)
                             for r in reads])
    batch = torch.from_numpy(chunks[:CTC_BATCH].astype(np.float16)).cuda()
    # random weights with the batchnorm stats at 0 / 1 let the activations
    # grow block by block (log-probs of ~1e4); the running stats are first
    # brought to the batch's, as training brings them: 50 training-mode
    # forwards of 16 chunks at momentum 0.1 (99.5 % of the way)
    with torch.no_grad():
        for _ in range(50):
            merge_bn_stats(model(batch[:16], train=True)[1])
    with torch.inference_mode():
        lp = model(batch)
        if lp.shape != (1200, CTC_BATCH, 7) \
                or not bool(torch.isfinite(lp).all()):
            fail(f"QuartzNet log-probs {tuple(lp.shape)} not finite/expected")
        cpu = CtcModel(cfg, device="cpu", seed=None)
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict()
                             .items()})
        x = batch[:CTC_CPU_CHUNKS]
        got, want = model(x).cpu(), cpu(x.cpu())
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / (1 + want.abs())).max().item()
        same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        print(f"QuartzNet 5x5 (NACGTXY, {model.n_params()} parameters) on "
              f"the card vs the port's CPU run, {CTC_CPU_CHUNKS} chunks: "
              f"log-probs max_abs {err:.3e} (tolerance 1e-3; largest "
              f"|log-prob| {want.abs().max().item():.3e}), max |a - b| / "
              f"(1 + |b|) "
              f"{rel:.3e} (tolerance 1e-4), argmax frames equal {same:.6f} "
              f"(tolerance >= 0.999)")
        if err > 1e-3 or rel > 1e-4 or same < 0.999:
            fail("the QuartzNet forward on the card disagrees with the CPU")
        # each stage of the forward at the batch, CUDA events
        act = ACTIVATIONS[cfg.encoder.activation]
        xs, stage = [batch.float()[:, None, :]], {}
        for i, block in enumerate(model.blocks):
            blk = cfg.blocks[i]
            xs.append(block(xs[-1], act, False, lambda y: y, []))
            stage[f"block {i} (filters {blk.filters}, k{blk.kernel[0]}, "
                  f"x{blk.repeat}{', separable' if blk.separable else ''})"
                  ] = elapsed_ms(lambda b=block, v=xs[-2]: b(
                      v, act, False, lambda y: y, []), 5)
        stage["decoder + log_softmax"] = elapsed_ms(
            lambda: torch.log_softmax(model.decoder(xs[-1]).permute(
                2, 0, 1), -1), 5)
        stage["forward (whole)"] = elapsed_ms(lambda: model(batch), 5)
        stage["forward + f16 [N, T', C] + fetch"] = host_ms(
            lambda: forward_f16(model, batch).cpu())
    print(f"QuartzNet forward at {CTC_BATCH} x 3600, by stage (ms, CUDA "
          f"events; fetch by host clock) on {card}: "
          + "; ".join(f"{k} {v:.3f}" for k, v in stage.items()))

    for name, beam in (("greedy", 1), ("beam 5", 5)):
        t0 = time.perf_counter()
        out = list(basecall_ctc(model, iter(reads), beamsize=beam))
        wall = time.perf_counter() - t0
        seqs = [a["sequence"] for _, a in out]
        if len(out) != len(reads) or not all(seqs) \
                or not all(set(s) <= set("ACGTXY") for s in seqs):
            fail(f"basecall_ctc ({name}) did not call every read")
        if beam == 1 and any(len(a["qstring"]) != len(a["sequence"])
                             for _, a in out):
            fail("basecall_ctc (greedy): a qstring of another length")
        n_samples = sum(len(r.signal) for r in reads)
        print(f"basecall_ctc {name}: {len(out)} reads, mean "
              f"{statistics.mean(map(len, seqs)):.0f} bases, "
              f"{n_samples / wall:.4e} samples/s (host clock) on {card}")
    with torch.inference_mode():
        lp_read = chunkops.stitch(forward_f16(model, torch.from_numpy(
            chunkops.chunk(reads[0].signal, 3600, 500).astype(np.float16))
            .cuda()).float().cpu().numpy(), 3600, 500,
            len(reads[0].signal), model.stride)
    t_greedy = host_ms(lambda: ctc_ops.collapse_path(
        lp_read.argmax(1), np.exp(lp_read.max(1)), cfg.alphabet))
    t_beam = host_ms(lambda: ctc_ops.beam_search(np.exp(lp_read),
                                                 cfg.alphabet, 5))
    print(f"host decode of one read ({len(lp_read)} frames): greedy "
          f"collapse {t_greedy:.2f} ms, beam 5 {t_beam:.2f} ms")

    # one training step at the batch, by stage (host clock, card waited)
    tbatch = simulated_ctc_batch(CTC_BATCH)
    m2 = CtcModel(cfg, device="cuda", seed=SEED)
    opt = make_optimizer(m2, lambda _: 1e-4)
    t = {}

    def step_parts():
        for p in m2.parameters():
            p.grad = None
        t0 = time.perf_counter()
        lp_t, stats = m2(tbatch[0], train=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = masked_ctc_loss(lp_t, tbatch[1], tbatch[2])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        opt.step()
        merge_bn_stats(stats)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in (("forward", t1 - t0), ("ctc loss", t2 - t1),
                     ("backward", t3 - t2), ("clip + AdamW + bn stats",
                                             t4 - t3)):
            t.setdefault(k, []).append(v * 1e3)
    for _ in range(4):
        step_parts()
    print(f"CTC training step at {CTC_BATCH} x 3600, medians of 3 after one "
          f"warm-up (ms, host clock) on {card}: " + "; ".join(
              f"{k} {statistics.median(v[1:]):.2f}" for k, v in t.items()))
    del m2, opt

    run = os.path.join(workroot, "ctc_run")
    toml = os.path.join(workroot, "quartznet.toml")
    config_lib.save(cfg, toml)
    t0 = time.perf_counter()
    cli(["train", run, "--config", toml, "--directory",
         os.path.join(workroot, "data"), "--epochs", "1", "--batch",
         str(CTC_BATCH), "--lr", CTC_LR, "--seed", str(SEED), "--device",
         "cuda", "-f"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(run, "losses_1.csv")) as fh:
        rows = list(csv.DictReader(fh))
    with open(os.path.join(run, "training.csv")) as fh:
        val = list(csv.DictReader(fh))[-1]
    losses = [float(r["loss"]) for r in rows]
    times = np.diff([0.0] + [float(r["time"]) for r in rows]) * 1e3
    print(f"train --config quartznet.toml: {len(rows)} steps of {CTC_BATCH}"
          f" in {wall:.1f} s; losses {[round(v, 4) for v in losses]}; step "
          f"times {[round(float(v), 1) for v in times]} ms; validation "
          f"loss {val['validation_loss']} mean_acc {val['validation_mean']}"
          f" on {card}")
    if len(rows) != TRAIN_STEPS or not all(map(math.isfinite, losses)) \
            or not statistics.mean(losses[-3:]) < losses[0]:
        fail("the CTC training run's losses are not finite or do not fall")
    trained, _ = load_model(run, device="cuda")
    bn = trained.blocks[1].convs[0].bn
    moved = float(bn.mean.abs().max()), float((bn.var - 1).abs().max())
    print(f"batchnorm running stats after training: max |mean| "
          f"{moved[0]:.3e}, max |var - 1| {moved[1]:.3e}")
    if not (moved[0] > 0 and moved[1] > 0):
        fail("the CTC training left the batchnorm running stats in place")
    # the validation runs on the running stats, which 8 steps at momentum
    # 0.1 bring 1 - 0.9^8 = 57 % of the way from 0 / 1 to the data's; with
    # the stats brought to the validation chunks' (as at the top of this
    # phase) the loss should fall to the training losses' size
    if not math.isfinite(float(val["validation_loss"])):
        fail("the CTC validation loss is not finite")
    _, valid = load_datasets(os.path.join(workroot, "data"))
    vx = torch.from_numpy(np.asarray(valid.chunks, np.float32)).cuda()
    vt = torch.from_numpy(np.asarray(valid.targets, np.int64)).cuda()
    vl = torch.from_numpy(np.asarray(valid.lengths, np.int64)).cuda()
    with torch.no_grad():
        before = float(masked_ctc_loss(trained(vx), vt, vl))
        for _ in range(50):
            merge_bn_stats(trained(vx, train=True)[1])
        after = float(masked_ctc_loss(trained(vx), vt, vl))
    print(f"CTC validation loss of the trained model on its {len(vx)} "
          f"validation chunks: {before:.4f} with its running stats, "
          f"{after:.4f} with the stats brought to the chunks'")
    if not (math.isfinite(before) and math.isfinite(after)):
        fail("the CTC validation loss is not finite")
    print(f"phase 8f wall time: {time.perf_counter() - t_phase:.1f} s on "
          f"{card}")


def simulated_ctc_batch(n: int):
    """A batch of phase 8's kind of ctc-data on the card: chunks [n, 3600],
    targets [n, 400], lengths [n]."""
    from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset

    c, t, l, _ = simulate_ctc_dataset(n, chunk_len=3600, target_len=400,
                                      seed=SEED + 7)
    return tuple(torch.from_numpy(a.astype(dt)).cuda() for a, dt in zip(
        (c, t, l), (np.float32, np.int64, np.int64)))


def _reads_fasta(reads, path: str) -> None:
    with open(path, "w") as fh:
        for r in reads:
            fh.write(f">{r.read_id}\n{r.sequence}\n")


def drive_mods(workroot: str, boot_dir: str, card: str):
    """Phase 8g: the modified-base classifier.  Trains a ``ModsConfig()``
    classifier with ``mods.train.fit`` on the card on seeded synthetic
    site windows (modified sites carry a level shift at the centre), then
    calls MODS_READS simulated reads through ``cli/basecaller.py::call_reads``
    with ``--mods-model --reference --bam`` and phase 8d's phase-A model
    (trained on simulated DNA, so that its calls hold CG sites), with the
    launch counts set to 0 just before; counts the BAM's MM/ML tags and
    holds the card's site probabilities of a read to the CPU's."""
    from xna_basecaller_tpu_torch.cli import basecaller
    from xna_basecaller_tpu_torch.data.bam import read_bam
    from xna_basecaller_tpu_torch.data.simulate import simulate_reads
    from xna_basecaller_tpu_torch.infer.basecall import basecall
    from xna_basecaller_tpu_torch.mods import (
        ModsConfig, ModsModel, call_mods, load_mods_model, save_mods_model,
    )
    from xna_basecaller_tpu_torch.mods.infer import (
        extract_features, find_motif_sites, site_probs,
    )
    from xna_basecaller_tpu_torch.mods.train import accuracy, fit
    from xna_basecaller_tpu_torch.utils.model_io import load_model

    t_phase = time.perf_counter()
    cfg = ModsConfig()
    rng = np.random.default_rng(SEED)
    labels = rng.integers(0, 2, MODS_SITES)
    sig = rng.normal(size=(MODS_SITES, cfg.sig_window)).astype(np.float32)
    sig[labels == 1, 24:40] += 0.8
    ctx = rng.integers(1, 5, size=(MODS_SITES, 2 * cfg.context + 1))
    ctx[:, cfg.context], ctx[:, cfg.context + 1] = 2, 3      # C, G
    tr = slice(0, MODS_TRAIN)
    te = slice(MODS_TRAIN, MODS_SITES)
    t0 = time.perf_counter()
    mods, hist = fit(cfg, sig[tr], ctx[tr], labels[tr], epochs=5, batch=256,
                     seed=SEED, device="cuda")
    torch.cuda.synchronize()
    acc = accuracy(cfg, mods, sig[te], ctx[te], labels[te])
    print(f"mods.train.fit on the card: {MODS_TRAIN} sites x 5 epochs in "
          f"{time.perf_counter() - t0:.2f} s, loss history "
          f"{[round(h, 4) for h in hist]}, held-out accuracy {acc:.4f}")
    if not hist[-1] < hist[0] or acc < 0.8:
        fail("the mods classifier did not learn the synthetic sites")
    mods_dir = os.path.join(workroot, "mods_model")
    save_mods_model(mods_dir, cfg, mods)

    model, mcfg = load_model(boot_dir, device="cuda")
    mreads = list(simulate_reads(MODS_READS, mean_len=MODS_LEN,
                                 seed=SEED + 5))
    fasta = os.path.join(workroot, "mods_ref.fa")
    _reads_fasta(mreads, fasta)
    bam = os.path.join(workroot, "mods.bam")
    args = basecaller.argparser().parse_args(
        [boot_dir, "reads", "--reference", fasta, "--bam", bam,
         "--mods-model", mods_dir])
    wrappers = training_wrappers()
    zero_launches(wrappers)
    t0 = time.perf_counter()
    stats = basecaller.call_reads(args, model, mcfg, iter(mreads),
                                  out=io.StringIO())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in launch_counts(wrappers).items() if n}
    records = read_bam(bam)[1]
    # ML is the SAM spec's B:C array, read back as "ML:B:C,..."
    mm = [t for r in records for t in r["tags"]
          if t.startswith("MM:Z:C+m?,")]
    ml = [t for r in records for t in r["tags"] if t.startswith("ML:")]
    if any(not t.startswith("ML:B:C,") for t in ml):
        fail("the BAM's ML tags are not B:C arrays")
    n_ml = sum(len(t.split(",")) - 1 for t in ml)
    with_mm = min(len(mm), len(ml))
    print(f"basecaller --mods-model --reference --bam: {stats['reads']} "
          f"reads in {wall:.2f} s, {len(records)} BAM records, {with_mm} "
          f"with MM/ML tags, {n_ml} site probabilities; launches "
          f"{launches}")
    if with_mm < MODS_READS // 2:
        fail("fewer than half the reads carry MM/ML tags")
    # card vs CPU on one read's sites, and call_mods' time per read
    calls = list(basecall(model, iter(mreads[:4])))
    read, attrs = calls[0]
    sites = find_motif_sites(attrs["sequence"], cfg.motif, cfg.motif_offset)
    feats = extract_features(read.signal, attrs["sequence"], attrs["moves"],
                             attrs["stride"], sites, cfg)
    if not len(sites):
        fail(f"read {read.read_id}'s call holds no CG site")
    cpu = ModsModel(cfg, mods.params(), device="cpu")
    p_card, p_cpu = site_probs(mods, *feats), site_probs(cpu, *feats)
    err = float(np.abs(p_card - p_cpu).max())
    print(f"site probabilities of read {read.read_id} ({len(sites)} CG "
          f"sites), card vs CPU: max_abs {err:.3e} (tolerance 1e-5)")
    if err > 1e-5:
        fail("the mods classifier on the card disagrees with the CPU")
    loaded = load_mods_model(mods_dir, device="cuda")
    per = []
    for r, a in calls:
        t0 = time.perf_counter()
        call_mods(loaded, r, dict(a))
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3)
    n_sites = [len(find_motif_sites(a["sequence"], "CG", 0))
               for _, a in calls]
    print(f"call_mods per read (host clock): {[round(v, 2) for v in per]} "
          f"ms for {n_sites} CG sites on {card}")
    print(f"phase 8g wall time: {time.perf_counter() - t_phase:.1f} s on "
          f"{card}")
    return launches


def simulated_pairs(n: int, bases: int):
    """``n`` template/complement reads of one random DNA sequence each
    (``simulate_squiggle``), and the sequences."""
    from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
    from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
    from xna_basecaller_tpu_torch.data.simulate import (
        SimReadObj, simulate_squiggle,
    )

    rng = np.random.default_rng(SEED + 9)
    pore = load_pore_model()
    reads, truth = [], {}
    for p in range(n):
        seq = "".join(rng.choice(list("ACGT"), size=bases))
        truth[f"t{p}"] = seq
        for kind, s in (("t", seq), ("c", reverse_complement_str(seq))):
            codes = np.array(["NACGTXY".index(c) for c in s], np.uint8)
            sig, _ = simulate_squiggle(codes, pore, rng)
            reads.append(SimReadObj(f"{kind}{p}", sig, s))
    return reads, truth


def decode_pair_by_stage(t1, i1, t2, i2, alphabet: str, padding: int = 40,
                         min_match: float = 0.80, min_len: int = 10,
                         min_coverage: float = 0.5) -> dict:
    """``infer/pair_decode.py::decode_pair``'s steps one at a time, with
    its defaults and the duplex command's padding, each timed on the host
    clock: the exit the pair takes ("joint call", or the reason it returns
    None: "min_len", "gate" (the simplex calls match below min_match over
    a local alignment that covers at least min_coverage of the template's
    call),
    "max_cells" (native.pair_viterbi's cap on (T1 + 1) x the widest
    window x ns), "empty" (the final cell unreachable)), the DP's cells,
    and the call."""
    from xna_basecaller_tpu_torch.eval.accuracy import accuracy, sw_align
    from xna_basecaller_tpu_torch.infer import pair_decode as pdec
    from xna_basecaller_tpu_torch.utils import native

    n_base = len(alphabet) - 1
    T1, ns = t1.shape[:2]
    T2 = t2.shape[0]
    d = {"frames": f"{T1} x {T2}"}
    t0 = time.perf_counter()
    c1, f1 = pdec.simplex_from_trans(t1, i1, n_base)
    c2, f2 = pdec.simplex_from_trans(t2, i2, n_base)
    d["simplex ms"] = (time.perf_counter() - t0) * 1e3
    d["simplex lengths"] = (len(c1), len(c2))
    if len(c1) < min_len or len(c2) < min_len:
        d["exit"] = "min_len"
        return d
    seq1 = "".join(alphabet[c] for c in c1)
    seq2 = "".join(alphabet[c] for c in c2)
    d["match"] = accuracy(seq1, seq2, min_coverage=min_coverage)
    # the local alignment that identity is taken over, and its coverage of
    # the template's call
    _, cigar, (_, _, r0, r1) = sw_align(seq2, seq1)
    d["match columns"] = sum(n for _, n in cigar)
    d["coverage"] = (r1 - r0) / len(seq1)
    d["seqs"] = (seq1, seq2)
    if d["match"] < min_match * 100:
        d["exit"] = "gate"
        return d
    t0 = time.perf_counter()
    env = pdec.build_envelope(T1, f1, T2, f2, pdec.nw_columns(seq1, seq2),
                              padding=padding)
    d["nw + envelope ms"] = (time.perf_counter() - t0) * 1e3
    # the windows as native.pair_viterbi reads them: row 0, then a row a
    # strand-1 frame, the last one stretched to the end of strand 2
    lo = np.maximum(env[:, 0], 0)
    hi = np.minimum(env[:, 1], T2)
    lo = np.minimum(lo, hi)
    hi[-1] = T2
    widths = np.concatenate([[min(int(env[0, 1]), T2) + 1], hi - lo + 1])
    d["widest window"] = (int(widths.max()), f"row {int(widths.argmax())}")
    d["median window"] = float(np.median(widths))
    d["cells"] = (T1 + 1) * int(widths.max()) * ns
    t0 = time.perf_counter()
    got = native.pair_viterbi(t1, i1, t2, i2, env, n_base)
    ms = (time.perf_counter() - t0) * 1e3
    if got is None:
        d["exit"] = ("max_cells" if d["cells"] > 500_000_000
                     else "no native library")
        return d
    d["pair viterbi ms"] = ms
    codes, frames = got
    if not len(codes):
        d["exit"] = "empty"
        return d
    d["exit"] = "joint call"
    d["call length"] = len(codes)
    d["first emission frame"] = int(frames[0])
    d["longest emission gap (frames)"] = int(np.diff(
        np.concatenate([[0], frames, [T1]])).max())
    d["call"] = "".join(alphabet[c] for c in codes)
    return d


def drive_duplex(workroot: str, boot_dir: str, card: str):
    """Phase 8h: duplex calling.  DUPLEX_PAIRS pairs of simulated
    template/complement reads (``simulate_squiggle``, ~9 samples a base)
    through ``xnacall duplex --pairs --pair-decode`` with phase 8d's
    phase-A model (the reads handed to the command through its
    ``get_reads``: no h5py on the card's machine), with the launch counts
    set to 0 just before; ``read_transition_probs`` on the card held to
    the CPU's plain route on one read; each pair through
    ``decode_pair_by_stage``: the card's time (the f32 forward, K2a and
    the stitch's gather) apart from each of the host's stages, and the
    exit each pair takes, which the command's reads must follow.  Fails
    unless every pair passes the match gate and reaches the pair Viterbi,
    each complement's simplex call (reverse-complemented through the
    alphabet) is at least DUPLEX_SIMPLEX_MIN identical to the simulated
    sequence, the joint calls' median identity is at least
    DUPLEX_JOINT_MIN, and a pair of unrelated strands (pair 0's template,
    pair 1's complement) is turned down at the gate."""
    import contextlib

    from xna_basecaller_tpu_torch.cli import main as cli
    from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
    from xna_basecaller_tpu_torch.data import fast5
    from xna_basecaller_tpu_torch.eval.accuracy import accuracy
    from xna_basecaller_tpu_torch.infer.basecall import basecall
    from xna_basecaller_tpu_torch.infer import pair_decode as pdec
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.ops import crf_cuda, crf_head, lstm_cuda
    from xna_basecaller_tpu_torch.utils.model_io import load_model

    t_phase = time.perf_counter()
    reads, truth = simulated_pairs(DUPLEX_PAIRS, DUPLEX_BASES)
    model, cfg = load_model(boot_dir, device="cuda")
    alphabet = cfg.alphabet

    # the f32 route on the card against the CPU's plain route, one read
    _build.launches["lstm_recurrence"] = 0
    _build.launches["backward_scan"] = 0
    _build.launches["crf_head_epilogue"] = 0
    tg, ig = pdec.read_transition_probs(model, reads[0].signal)
    f32_launches = {"K1 f32": _build.launches["lstm_recurrence"],
                    "K2a": _build.launches["backward_scan"],
                    "head f32": _build.launches["crf_head_epilogue"]}
    cpu = Model(cfg, device="cpu", seed=None)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tc, ic = pdec.read_transition_probs(cpu, reads[0].signal)
    err = float(np.abs(np.exp(tg) - np.exp(tc)).max())
    err_i = float(np.abs(np.exp(ig) - np.exp(ic)).max())
    print(f"read_transition_probs of {reads[0].read_id} "
          f"({len(reads[0].signal)} samples, {tg.shape[0]} frames) on the "
          f"card vs the CPU's plain route: posteriors max_abs {err:.3e}, "
          f"initial {err_i:.3e} (tolerance 1e-3); launches {f32_launches}")
    if err > 1e-3 or err_i > 1e-3:
        fail("read_transition_probs on the card disagrees with the CPU")
    if f32_launches["head f32"] != 1:
        fail("the f32 forward did not launch the head's kernel once")
    # read_transition_probs' stages on one read (CUDA events; the fetch
    # and the host's log by host clock)
    from xna_basecaller_tpu_torch.data import chunkops
    from xna_basecaller_tpu_torch.ops import crf, lstm
    from xna_basecaller_tpu_torch.ops.conv import conv_stack_forward
    nb, sl = cfg.n_base, cfg.state_len
    with torch.inference_mode():
        xc = torch.from_numpy(chunkops.chunk(reads[0].signal, 3600, 500)
                              ).cuda()
        sc = model(xc, compute_dtype=torch.float32)
        xf = conv_stack_forward(model.conv, xc[:, None, :],
                                cfg.encoder.activation).permute(2, 0, 1)
        p32 = model.rnn[0].params(torch.float32)
        xp32 = lstm.input_projection(p32, xf.contiguous())
        trans, _ = crf.compute_transition_probs(
            model.seqdist.reverse_complement(sc), nb, sl)
        parts = {
            "f32 forward": elapsed_ms(lambda: model(
                xc, compute_dtype=torch.float32), 3),
            "K1 f32 (one layer)": elapsed_ms(
                lambda: lstm_cuda.lstm_recurrence(xp32, p32["w_hh"], True),
                3),
            "reverse_complement + compute_transition_probs (K2a)":
                elapsed_ms(lambda: crf.compute_transition_probs(
                    model.seqdist.reverse_complement(sc), nb, sl), 3),
            "gather + fetch": host_ms(lambda: trans.transpose(0, 1)
                                      .reshape(-1, *trans.shape[2:])
                                      [:tg.shape[0]].cpu()),
        }
    probs = np.exp(tg)
    parts["host log"] = host_ms(lambda: np.log(probs + 1e-30))
    print(f"read_transition_probs by stage, {xc.shape[0]} chunks (ms) on "
          f"{card}: " + "; ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    # each pair through decode_pair's steps one by one: the card's
    # read_transition_probs of both strands (host clock, the card waited),
    # then the host's simplex decodes, NW + envelope and pair Viterbi, and
    # the exit the pair takes
    diag = []
    for p in range(DUPLEX_PAIRS):
        t0 = time.perf_counter()
        t1, i1 = pdec.read_transition_probs(model, reads[2 * p].signal)
        t2, i2 = pdec.read_transition_probs(model, reads[2 * p + 1].signal,
                                            reverse=True)
        card_ms = (time.perf_counter() - t0) * 1e3 / 2
        if p == 0:
            repeat = bool(np.array_equal(t1, tg) and np.array_equal(i1, ig))
            template0 = (t1, i1)
        d = decode_pair_by_stage(t1, i1, t2, i2, alphabet)
        d["card ms a read"] = card_ms
        if "seqs" in d:
            # both simplex calls are in the template's orientation
            d["simplex accuracy against the simulated sequence"] = tuple(
                accuracy(truth[f"t{p}"], x) for x in d["seqs"])
        if "call" in d:
            d["joint call accuracy"] = accuracy(truth[f"t{p}"], d["call"])
        if p == 1:
            # unrelated strands: pair 0's template with this complement
            unrelated = decode_pair_by_stage(*template0, t2, i2, alphabet)
            unrelated_call = pdec.decode_pair(*template0, t2, i2, alphabet)
        diag.append(d)
        print(f"pair {p}: " + "; ".join(
            f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in d.items() if k not in ("call", "seqs")))
    exits = collections.Counter(d["exit"] for d in diag)

    def span(key, rows):
        vals = [d[key] for d in rows if key in d]
        return (f"{min(vals):.1f}-{max(vals):.1f}" if vals
                else "not run on any pair")
    ran = [d for d in diag if "pair viterbi ms" in d]
    per_cell = [d["pair viterbi ms"] * 1e6 / d["cells"] for d in ran]
    print(f"decode_pair's exits over the {DUPLEX_PAIRS} pairs: "
          f"{dict(exits)}; read_transition_probs bit-equal across two calls:"
          f" {repeat}")
    print(f"duplex split on {card}: read_transition_probs on the card "
          f"{span('card ms a read', diag)} ms a read (host clock, the card "
          f"waited); on the host, a pair: simplex decodes of both strands "
          f"{span('simplex ms', diag)} ms, NW + envelope "
          f"{span('nw + envelope ms', diag)} ms, pair Viterbi on matched "
          f"pairs {span('pair viterbi ms', ran)} ms over {len(ran)} pairs "
          f"(cells {[d['cells'] for d in ran]}, "
          f"{[round(v, 3) for v in per_cell]} ns a cell)")
    comp = [d.get("simplex accuracy against the simulated sequence",
                  (0.0, 0.0)) for d in diag]
    joint = [d.get("joint call accuracy", 0.0) for d in diag]
    print(f"simplex identity to the simulated sequence, template: "
          f"{[c[0] for c in comp]} %; complement (reverse-complemented "
          f"through the alphabet): {[c[1] for c in comp]} % (each must be "
          f">= {DUPLEX_SIMPLEX_MIN})")
    print(f"joint call identity to the simulated sequence: {joint} %, "
          f"median {float(np.median(joint))} (must be >= "
          f"{DUPLEX_JOINT_MIN}); call lengths "
          f"{[d.get('call length') for d in diag]} of {DUPLEX_BASES}")
    print(f"unrelated pair (t0 with c1): exit {unrelated['exit']}, match "
          f"{unrelated.get('match')}, coverage {unrelated.get('coverage')}, "
          f"match columns {unrelated.get('match columns')}; decode_pair "
          f"{'None' if unrelated_call is None else 'made a joint call'}")
    if len(ran) != DUPLEX_PAIRS:
        fail(f"only {len(ran)} of {DUPLEX_PAIRS} matched pairs reached the "
             "pair Viterbi")
    if min(c[1] for c in comp) < DUPLEX_SIMPLEX_MIN:
        fail("a complement's simplex call is under "
             f"{DUPLEX_SIMPLEX_MIN} % identical to the simulated sequence")
    if float(np.median(joint)) < DUPLEX_JOINT_MIN:
        fail(f"the joint calls' median identity is under {DUPLEX_JOINT_MIN}"
             " %")
    if unrelated["exit"] != "gate" or unrelated_call is not None:
        fail("decode_pair did not turn down a pair of unrelated strands")
    # the CLI
    with open(os.path.join(workroot, "pairs.txt"), "w") as fh:
        fh.writelines(f"t{p} c{p}\n" for p in range(DUPLEX_PAIRS))
    by_id = {r.read_id: r for r in reads}
    real_get_reads = fast5.get_reads
    fast5.get_reads = lambda directory, read_ids=None, **kw: iter(
        [by_id[r] for r in sorted(by_id) if read_ids is None
         or r in read_ids])
    wrappers = {**training_wrappers(),
                "K2b-qual": crf_cuda.forward_viterbi_qual,
                "K2c-qual": crf_cuda.viterbi_traceback_qual}
    zero_launches(wrappers)
    _build.launches["lstm_recurrence.f32"] = 0
    out, merged = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli(["duplex", boot_dir, "reads", "--pairs",
                 os.path.join(workroot, "pairs.txt"), "--pair-decode",
                 "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in launch_counts(wrappers).items() if n}
        launches["K1-f32"] = _build.launches["lstm_recurrence.f32"]
        # the same pairs through the consensus merge alone
        with contextlib.redirect_stdout(merged):
            cli(["duplex", boot_dir, "reads", "--pairs",
                 os.path.join(workroot, "pairs.txt"), "--device", "cuda"])
    finally:
        fast5.get_reads = real_get_reads

    def accuracies(text):
        lines = text.splitlines()
        return lines[0::4], lines[1::4], [
            accuracy(truth[h[1:].split(";")[0]], s)
            for h, s in zip(lines[0::4], lines[1::4])]
    heads, seqs, accs = accuracies(out.getvalue())
    _, merge_seqs, merge_accs = accuracies(merged.getvalue())
    simplex = []
    for r, a in basecall(model, iter(reads[:4])):
        ref = truth[f"t{r.read_id[1:]}"]
        if r.read_id.startswith("c"):
            ref = reverse_complement_str(ref)
        simplex.append(accuracy(ref, a["sequence"]))
    print(f"xnacall duplex --pairs --pair-decode: {len(heads)} duplex reads "
          f"of {DUPLEX_PAIRS} pairs in {wall:.2f} s; lengths "
          f"{[len(x) for x in seqs]} of {DUPLEX_BASES}; accuracy against "
          f"the simulated sequence {[round(a, 2) for a in accs]} (without "
          f"--pair-decode, the consensus merge: "
          f"{[round(a, 2) for a in merge_accs]}; simplex calls of the first "
          f"two pairs {[round(a, 2) for a in simplex]}); launches "
          f"{launches} on {card}")
    if len(heads) != DUPLEX_PAIRS or not all(seqs) \
            or len(merge_seqs) != DUPLEX_PAIRS:
        fail("the duplex command did not call every pair")
    # a pair whose decode_pair made a joint call gives it; any other pair
    # the consensus merge's read
    differ = [p for p, d in enumerate(diag) if seqs[p] != (
        d["call"] if d["exit"] == "joint call" else merge_seqs[p])]
    print(f"--pair-decode reads equal to decode_pair's joint call or, where "
          f"it made none, the consensus merge's: {DUPLEX_PAIRS - len(differ)}"
          f" of {DUPLEX_PAIRS} (differing pairs {differ})")
    if differ:
        fail("the duplex command's reads are not decode_pair's calls")
    print(f"phase 8h wall time: {time.perf_counter() - t_phase:.1f} s on "
          f"{card}")
    return f32_launches, launches


def drive_evaluate_view_export(workroot: str, boot_dir: str, card: str):
    """Phase 8i: ``xnacall evaluate --weights 1,2 --poa`` on phase 8's
    ctc-data with phase 8d's phase-A checkpoints 1 and 2 (the launch counts
    set to 0 just before), then ``view`` and ``export``."""
    import contextlib

    from xna_basecaller_tpu_torch.cli import main as cli

    t_phase = time.perf_counter()
    wrappers = training_wrappers()
    zero_launches(wrappers)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli(["evaluate", boot_dir, "--directory",
             os.path.join(workroot, "data"), "--weights", "1,2", "--poa",
             "--chunks", str(EVAL_CHUNKS), "--batchsize", str(EVAL_BATCH),
             "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {k: n for k, n in launch_counts(wrappers).items() if n}
    text = out.getvalue()
    print("xnacall evaluate --weights 1,2 --poa: " + " | ".join(
        text.splitlines()) + f"; launches {launches} on {card}")
    if text.count("* mean") != 2 or "* poa mean" not in text:
        fail("evaluate did not report both checkpoints and the POA")
    n_batches = 2 * math.ceil(EVAL_CHUNKS / EVAL_BATCH)
    if launches.get("K2a", 0) < n_batches or launches.get("K1", 0) < \
            5 * n_batches:
        fail(f"evaluate did not run K1 and K2a/b/c on its {n_batches} "
             "batches")
    # export writes every weight as JSON text (~20 characters each): the
    # flagship's 24.8 M would take about a minute, so a model of the
    # flagship's width with one LSTM layer (random weights from SEED) is
    # exported
    from dataclasses import replace

    from xna_basecaller_tpu_torch.core.config import ModelConfig
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.train import checkpoint as ckpt
    from xna_basecaller_tpu_torch.utils.weights import params_to_jax

    one = ModelConfig()
    one = replace(one, encoder=replace(one.encoder, num_rnn_layers=1))
    one_dir = os.path.join(workroot, "one_layer")
    os.makedirs(one_dir)
    config_lib.save(one, one_dir)
    ckpt.save_checkpoint(one_dir, 1, params_to_jax(
        Model(one, device="cpu", seed=SEED).state_dict()))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli(["view", boot_dir])
        cli(["export", one_dir, "--output",
             os.path.join(workroot, "model.json"), "--device", "cuda"])
    t_export = time.perf_counter() - t0
    with open(os.path.join(workroot, "model.json")) as fh:
        exported = json.load(fh)
    print("xnacall view: " + " | ".join(out.getvalue().splitlines()[:-1])
          + f"; export of the one-layer model: {len(exported['layers'])} "
          f"layers, alphabet {exported['alphabet']}, "
          f"{os.path.getsize(os.path.join(workroot, 'model.json'))} bytes "
          f"in {t_export:.1f} s")
    if len(exported["layers"]) != 3 + 1 + 1:
        fail("export did not write the model's 5 layers")
    print(f"phase 8i wall time: {time.perf_counter() - t_phase:.1f} s on "
          f"{card}")
    return launches


# phase 8j: the reads the installed models call, and the registry's name
TAIL_READS, TAIL_MODEL = 8, "xna_r9.4.1_e8_sup@v3.3"


def _tail_forensics(root: str) -> str:
    """``eval/forensics.py`` on tables written here with ``csv``: the
    demux table read, its derived columns and a filter chain (with its
    ``.csv.gz``), an eventalign table with reverse-complemented polished
    k-mers repaired, and UB-area quality windows.  Fails on a wrong
    value; returns a line to print."""
    import csv
    import gzip

    from xna_basecaller_tpu_torch.eval import forensics

    demux = os.path.join(root, "demux.csv")
    with open(demux, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(["read_id", "barcode_name", "read_length", "read_start",
                    "read_end", "n_matches", "target_length",
                    "barcode_distance"])
        w.writerows([["a", "T1", 100, 0, 90, 85, 100, 1],
                     ["b", "PC_T1", 250, 0, 240, 230, 100, 2],
                     ["c", "T2", 400, 0, 380, 300, 400, 7],
                     ["d", "T1", 90, 0, 80, 40, 100, 0]])
    df = forensics.read_demux(demux)
    kept = forensics.filter_demux(df, read_len_interval=(95, 300),
                                  max_barcode_dist=5, read_type="XNA",
                                  output_dir=root)
    gz = os.path.join(root, "demux-k_15-w_5-XNA_only-l_95_300-d_5.csv.gz")
    with gzip.open(gz, "rt") as fh:
        saved = fh.read().splitlines()
    ev = os.path.join(root, "T1_+_eventalign.tsv")
    with open(ev, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t", lineterminator="\n")
        w.writerow(["contig", "position", "reference_kmer", "read_name",
                    "event_index", "model_kmer", "samples"])
        w.writerows([["T1", 0, "GTNCGT", "r", "", "NNNNNN", "1.0,2.0"],
                     ["T1", 1, "AGTNCG", "r", 1, "AGTNCG", "3.0"]])
    events = forensics.read_eventalign(ev)

    class Refs:
        x_pos = {"T": [10]}
        x_pos_rev = {"T": [9]}

    recs = [dict(read_id=r, target_id="T", strand=st, target_length=20,
                 target_start=0, read_start=0, cs=":20")
            for r, st in (("f", "F"), ("r", "R"))]
    wins = forensics.all_ub_area_qual(
        recs, Refs(), {"f": np.arange(20.0), "r": np.arange(20.0)}, margin=1)
    checks = {
        "read_demux": (df.loc["b", "type"], df.loc["c", "template_coverage"])
        == ("PC", 0.95),
        "filter_demux": kept.index == ["a"] and len(saved) == 2
        and saved[1].startswith("a,T1,100,"),
        "read_eventalign": list(events["reference_kmer"]) == ["ACGNAC",
                                                              "AGTNCG"],
        "all_ub_area_qual": {k: v.tolist() for k, v in wins.items()}
        == {"f": [[9.0, 10.0, 11.0]], "r": [[8.0, 9.0, 10.0]]},
    }
    if not all(checks.values()):
        fail(f"forensics gave wrong values: {checks}")
    return (f"forensics without pandas: read_demux {len(df)} rows, "
            f"filter_demux kept {kept.index} and wrote "
            f"{os.path.basename(gz)}, read_eventalign repaired "
            f"{list(events['reference_kmer'])}, all_ub_area_qual "
            f"{ {k: v.tolist() for k, v in wins.items()} }")


def drive_tail(workroot: str, boot_dir: str, reads, card: str):
    """Phase 8j: the commands that need no card, on the card's machine,
    and the models they install called on the card.  ``xnacall download
    --models`` from a ``file://`` mirror whose registry archive holds
    phase 8d's phase-A model, and ``download --from`` a directory of its
    ``config.toml`` and a reference ``weights_1.tar`` of the same model
    (``utils/torch_import.export_state_dict``); each install, loaded with
    ``load_model(device="cuda")``, calls the first TAIL_READS of phase 4's
    reads as the source model does, byte for byte, with the launch counts
    of K1 and K2a-c set to 0 just before.  ``comp_basecalls_perf`` over
    phase 8d's seed directories reproduces the winner's
    ``results_summ-POC-test.csv``; ``forensics`` reads, repairs and
    filters tables the phase writes (this machine has no pandas);
    ``convert`` runs only where h5py is installed."""
    import contextlib
    import csv
    import importlib.util
    import pathlib
    import zipfile

    from xna_basecaller_tpu_torch.cli import main as cli
    from xna_basecaller_tpu_torch.infer.basecall import basecall
    from xna_basecaller_tpu_torch.ops import crf_cuda, lstm_cuda
    from xna_basecaller_tpu_torch.tools.comp_basecalls_perf import (
        comp_basecalls_perf,
    )
    from xna_basecaller_tpu_torch.train.checkpoint import latest_epoch
    from xna_basecaller_tpu_torch.utils.model_io import load_model
    from xna_basecaller_tpu_torch.utils.torch_import import (
        export_state_dict,
    )

    t_phase = time.perf_counter()
    root = os.path.join(workroot, "tail")
    mirror = os.path.join(root, "mirror")
    registry = os.path.join(root, "registry")
    os.makedirs(mirror)
    epoch = latest_epoch(boot_dir)
    with zipfile.ZipFile(os.path.join(mirror, f"{TAIL_MODEL}.zip"),
                         "w") as zf:
        for f in ("config.toml", f"weights_{epoch}.npz"):
            zf.write(os.path.join(boot_dir, f), arcname=f"{TAIL_MODEL}/{f}")
    source, _ = load_model(boot_dir, device="cuda")
    tar_dir = os.path.join(root, "reference_layout")
    os.makedirs(tar_dir)
    shutil.copy(os.path.join(boot_dir, "config.toml"), tar_dir)
    torch.save(export_state_dict(source.state_dict()),
               os.path.join(tar_dir, "weights_1.tar"))
    out = io.StringIO()
    before = os.environ.get("XNACALL_MODEL_BASE_URL")
    os.environ["XNACALL_MODEL_BASE_URL"] = pathlib.Path(mirror).as_uri()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli(["download", "--models", "--directory", registry])
    finally:
        if before is None:
            del os.environ["XNACALL_MODEL_BASE_URL"]
        else:
            os.environ["XNACALL_MODEL_BASE_URL"] = before
    t_mirror = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli(["download", "--from", tar_dir, "--model", "from_tar",
             "--directory", registry])
    t_tar = time.perf_counter() - t0
    print(f"xnacall download --models (file:// mirror, weights_{epoch}.npz"
          f" of phase A) in {t_mirror:.2f} s, download --from a "
          f"weights_1.tar in {t_tar:.2f} s: "
          + " | ".join(out.getvalue().splitlines()))

    def calls(model):
        return [(r.read_id, a["sequence"], a["qstring"])
                for r, a in basecall(model, iter(reads[:TAIL_READS]))]
    want = calls(source)
    wrappers = {"K1": lstm_cuda.lstm_recurrence,
                "K2a": crf_cuda.backward_scan,
                "K2b": crf_cuda.forward_viterbi,
                "K2c": crf_cuda.viterbi_traceback}
    launches = {}
    for install in (TAIL_MODEL, "from_tar"):
        model, _ = load_model(os.path.join(registry, install), device="cuda")
        zero_launches(wrappers)
        got = calls(model)
        torch.cuda.synchronize()
        launches[install] = launch_counts(wrappers)
        same = sum(g == w for g, w in zip(got, want))
        print(f"{install}, installed and loaded on the card: {same} of "
              f"{len(want)} calls equal the source model's (bases "
              f"{sum(len(c[1]) for c in got)}); launches "
              f"{launches[install]}")
        if got != want:
            fail(f"the model installed as {install} calls otherwise than "
                 "its source")
        if not all(launches[install].values()):
            fail(f"{install}'s calls did not launch K1 and K2a-c")

    # comp_basecalls_perf over the north-star chain's seed directories
    ns = os.path.join(workroot, "northstar")
    with open(os.path.join(ns, "northstar_summary.json")) as fh:
        win = json.load(fh)["winner_dir"]
    dirs = [os.path.join(ns, f"spliced_model_s{s}") for s in (25, 26)]
    if os.path.join(ns, win) not in dirs:   # an ensemble or a soup won
        dirs.append(os.path.join(ns, win))
    logs = []
    view = comp_basecalls_perf(dirs, exp="POC", split="test",
                               out_csv=os.path.join(root, "comp.csv"),
                               log=logs.append)
    with open(os.path.join(ns, win, "basecalls-POC-test",
                           "results_summ-POC-test.csv"), newline="") as fh:
        summ = next(csv.DictReader(fh))
    rows = [i for i, r in enumerate(view["run"].tolist()) if r == win]
    print(f"comp_basecalls_perf over {[os.path.basename(d) for d in dirs]}"
          f" (POC, test):\n" + "\n".join(logs))
    if len(rows) != 1:
        fail(f"comp_basecalls_perf has {len(rows)} rows of the winner {win}")
    differ = []
    for name in view.columns[1:]:
        v, text = view[name][rows[0]], summ[name]
        if view[name].dtype.kind == "f":
            same = (math.isnan(v) and text in ("", "nan", "NaN")) or (
                text not in ("", "nan", "NaN") and float(text) == v)
        else:
            same = str(v) == text
        if not same:
            differ.append((name, v, text))
    print(f"the winner's row ({win}) against its results_summ-POC-test.csv:"
          f" {len(view.columns) - 1 - len(differ)} of "
          f"{len(view.columns) - 1} columns equal")
    if differ:
        fail(f"comp_basecalls_perf's row of the winner differs: {differ}")

    print(_tail_forensics(root))
    if importlib.util.find_spec("h5py") is None:
        print("xnacall convert was not run: h5py, which it needs to read "
              "chunkify HDF5, is not installed on this machine")
    else:
        import h5py

        rng = np.random.default_rng(SEED)
        h5 = os.path.join(root, "chunkify.hdf5")
        with h5py.File(h5, "w") as fh:
            g = fh.create_group("Reads").create_group("read_0")
            g.create_dataset("Dacs", data=rng.integers(
                0, 2000, 12000).astype(np.int16))
            g.create_dataset("Reference", data=rng.integers(0, 4, 1500))
            g.create_dataset("Ref_to_signal",
                             data=np.sort(rng.integers(0, 12000, 1500)))
        with contextlib.redirect_stdout(out):
            cli(["convert", h5, os.path.join(root, "converted"),
                 "--chunksize", "800"])
        n = len(np.load(os.path.join(root, "converted", "chunks.npy")))
        print(f"xnacall convert: {n} chunks of 800 samples")
        if not n:
            fail("convert wrote no chunks")
    print(f"phase 8j wall time: {time.perf_counter() - t_phase:.1f} s on "
          f"{card}")
    return launches


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline", default=None, metavar="DIR",
        help="another tree of this repository (e.g. the parent commit, "
             "unpacked by git archive) whose K1, K7, K2a, K2b, K2c, K4, K6a, "
             "K6b and beam kernel are timed in turns with this tree's (the "
             "CRF kernels also held bit-equal), and its decode chain")
    args = parser.parse_args()
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from xna_basecaller_tpu_torch.core.config import ModelConfig
    from xna_basecaller_tpu_torch.data import chunkops
    from xna_basecaller_tpu_torch.data.simulate import (
        simulate_ctc_dataset, simulate_reads,
    )
    from xna_basecaller_tpu_torch.infer.basecall import run_basecaller
    from xna_basecaller_tpu_torch.models.crf_model import (
        QUANT_SCALE, Model, crf_head_forward,
    )
    from xna_basecaller_tpu_torch.ops import _build, crf, crf_cuda, lstm
    from xna_basecaller_tpu_torch.ops import crf_head, lstm_cuda
    from xna_basecaller_tpu_torch.ops.conv import conv_stack_forward

    # -- 1. card and build ---------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build()
    baseline = baseline_kernels(args.baseline) if args.baseline else None
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print(_build.build_log())
    t0 = time.perf_counter()
    from xna_basecaller_tpu_torch.utils import native
    print(f"native host library (g++, native/xna_native.cpp): "
          f"{'built' if native.available() else 'NOT BUILT'} in "
          f"{time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    cfg = ModelConfig()
    enc = cfg.encoder
    nb, sl = cfg.n_base, cfg.state_len
    chunksize = cfg.basecaller.chunksize
    overlap = cfg.basecaller.overlap
    batchsize = cfg.basecaller.batchsize
    model = Model(cfg, device=dev, seed=SEED).eval()
    reads = list(simulate_reads(N_READS, mean_len=MEAN_LEN, seed=SEED))
    chunks = np.concatenate([chunkops.chunk(r.signal, chunksize, overlap)
                             for r in reads])
    n_batches = math.ceil(len(chunks) / batchsize)
    if len(chunks) < 2 * batchsize:
        fail(f"only {len(chunks)} chunks: fewer than two full batches")
    batch = torch.from_numpy(chunks[:batchsize].astype(np.float16)).to(dev)
    # the same batch as the quantized path uploads it
    codes = torch.from_numpy(np.clip(np.rint(
        chunks[:batchsize] * QUANT_SCALE), -127, 127).astype(np.int8)).to(dev)
    print(f"reads {N_READS}, samples {sum(len(r.signal) for r in reads)}, "
          f"chunks {len(chunks)}, batches {n_batches}")

    results = {}
    cpu_model = Model(cfg, device="cpu", seed=None)
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})

    # -- 2. each kernel against its plain version, main-path tensors -----
    with torch.inference_mode():
        x = conv_stack_forward(model.conv, batch.float()[:, None, :],
                               enc.activation)
        x = x.permute(2, 0, 1).contiguous()                  # [720,256,768]
        layer0 = model.rnn[0]
        rev0 = model.directions[0]
        for name, dtype, tol in (("bf16", torch.bfloat16, 5e-2),
                                 ("f32", torch.float32, 1e-4)):
            p = layer0.params(dtype)
            xp = lstm.input_projection(p, x.to(dtype))
            got = lstm_cuda.lstm_recurrence(xp, p["w_hh"], rev0)
            want = lstm.lstm_recurrence(xp, p["w_hh"], rev0)
            err = (got.float() - want.float()).abs()
            print(f"K1 {name} {tuple(xp.shape)} reverse={rev0}: max_abs "
                  f"{err.max().item():.3e} mean_abs {err.mean().item():.3e}"
                  f" (tolerance max_abs {tol})")
            if not bool(torch.isfinite(got.float()).all()) \
                    or err.max().item() > tol:
                fail(f"K1 {name} disagrees with its plain version")
            # repeatability: the kernel adds the chunks of h in index
            # order, whichever finishes first
            again = lstm_cuda.lstm_recurrence(xp, p["w_hh"], rev0)
            print(f"K1 {name} called twice on the same xp: elements "
                  f"differing {(again != got).float().mean().item():.4f} "
                  f"(tolerance 0)")
            if not torch.equal(again, got):
                fail(f"K1 {name} is not bit-repeatable")
            results[f"K1_{name}_err"] = err.max().item()
            if name == "bf16":
                k1_inputs = (xp, p["w_hh"])
        # K1 bf16 at the XNA batch: one launch (the wide geometry), bit-equal
        # to the launches of 256 and 128 rows it replaced
        p = layer0.params(torch.bfloat16)
        x_xna = conv_stack_forward(
            model.conv, torch.from_numpy(
                chunks[:XNA_K1_ROWS].astype(np.float16)).to(dev).float()[
                    :, None, :], enc.activation)
        xp = lstm.input_projection(
            p, x_xna.permute(2, 0, 1).contiguous().to(torch.bfloat16))
        k1 = lstm_cuda.lstm_recurrence
        keys = ("lstm_recurrence", "lstm_recurrence.wide")
        before = [_build.launches[key] for key in keys]
        got = k1(xp, p["w_hh"], rev0)
        counted = tuple(_build.launches[key] - n
                        for key, n in zip(keys, before))
        err = (got.float() - lstm.lstm_recurrence(
            xp, p["w_hh"], rev0).float()).abs().max().item()
        again = k1(xp, p["w_hh"], rev0)
        parts = torch.cat([k1(xp[:, a:b].contiguous(), p["w_hh"], rev0)
                           for a, b in ((0, 256), (256, XNA_K1_ROWS))], 1)
        print(f"K1 bf16 {tuple(xp.shape)} reverse={rev0}: launches "
              f"{counted[0]}, on the wide geometry {counted[1]} (expected "
              f"1, 1); max_abs {err:.3e} (tolerance max_abs 5e-2); called "
              f"twice: elements differing "
              f"{(again != got).float().mean().item():.4f}; against rows "
              f"0-256 and 256-{XNA_K1_ROWS} run apart: elements differing "
              f"{(parts != got).float().mean().item():.4f} (tolerance 0)")
        if counted != (1, 1):
            fail(f"K1 bf16 at {XNA_K1_ROWS} rows took {counted[0]} "
                 f"launches, {counted[1]} on the wide geometry")
        if not bool(torch.isfinite(got.float()).all()) or err > 5e-2:
            fail(f"K1 bf16 at {XNA_K1_ROWS} rows disagrees with its plain "
                 "version")
        if not torch.equal(again, got):
            fail(f"K1 bf16 at {XNA_K1_ROWS} rows is not bit-repeatable")
        if not torch.equal(parts, got):
            fail(f"K1 bf16 at {XNA_K1_ROWS} rows differs from its rows run "
                 "apart")
        results["K1_bf16_err"] = max(results["K1_bf16_err"], err)
        del x_xna, xp, got, again, parts
        # K1's f32 route at duplex's shapes (a read's chunks), both ways
        p = layer0.params(torch.float32)
        k1f_err = results["K1_f32_err"]
        for n_rows in DUPLEX_K1_ROWS:
            xp = lstm.input_projection(p, x[:, :n_rows].float().contiguous())
            for rev in (False, True):
                got = lstm_cuda.lstm_recurrence(xp, p["w_hh"], rev)
                err = (got - lstm.lstm_recurrence(xp, p["w_hh"], rev)).abs()
                again = lstm_cuda.lstm_recurrence(xp, p["w_hh"], rev)
                print(f"K1 f32 {tuple(xp.shape)} reverse={rev}: max_abs "
                      f"{err.max().item():.3e} (tolerance 1e-4); called "
                      f"twice: elements differing "
                      f"{(again != got).float().mean().item():.4f} "
                      f"(tolerance 0)")
                if not bool(torch.isfinite(got).all()) \
                        or err.max().item() > 1e-4:
                    fail(f"K1 f32 at {n_rows} rows disagrees with its plain "
                         "version")
                if not torch.equal(again, got):
                    fail(f"K1 f32 at {n_rows} rows is not bit-repeatable")
                k1f_err = max(k1f_err, err.max().item())
        results["K1-f32_err"] = k1f_err
        k7_err, k7_inputs = check_int8_kernel(model, x)

        scores = model(batch)                                 # [720,256,1512]
        if scores.shape != (720, batchsize, cfg.n_score) \
                or not bool(torch.isfinite(scores).all()):
            fail(f"scores {tuple(scores.shape)} not finite/expected")
        betas = crf_cuda.backward_scan(scores, nb, sl)
        betas_p = crf.backward_scores(scores, nb, sl)
        # |a - b| <= 1e-5 + 1e-5 |b|, written as one ratio
        rel = ((betas - betas_p).abs() / (1 + betas_p.abs())).max().item()
        logz, logz_p = crf.logz_from_betas(betas), crf.logz_from_betas(
            betas_p)
        logz_rel = ((logz - logz_p).abs() / logz_p.abs()).max().item()
        print(f"K2a betas max_rel {rel:.3e}, logZ max_rel {logz_rel:.3e} "
              "(tolerance rtol 1e-5)")
        if rel > 1e-5 or logz_rel > 1e-5:
            fail("K2a disagrees with its plain version")
        results["K2a_err"] = (betas - betas_p).abs().max().item()

        bp, v_final = crf_cuda.forward_viterbi(scores, betas, logz, nb, sl)
        bp_p, v_p = crf.forward_viterbi(scores, betas, logz, nb, sl)
        labels_k = crf.viterbi_traceback(bp, v_final, nb, sl)
        labels_p = crf.viterbi_traceback(bp_p, v_p, nb, sl)
        bp_share = (bp != bp_p).float().mean().item()
        lab_share = (labels_k != labels_p).float().mean().item()
        v_err = (v_final - v_p).abs().max().item()
        print(f"K2b backpointers differing {bp_share:.3e}, label frames "
              f"differing {lab_share:.3e} (tolerance 1e-4), v_final max_abs "
              f"{v_err:.3e}")
        if lab_share > 1e-4:
            fail("K2b disagrees with its plain version")
        results["K2b_err"] = v_err

        labels = crf_cuda.viterbi_traceback(bp, v_final, nb, sl)
        n_diff = int((labels != labels_k).sum().item())
        print(f"K2c labels differing from the plain traceback: {n_diff} "
              "(tolerance 0)")
        if n_diff:
            fail("K2c disagrees with its plain version")
        results["K2c_err"] = float(n_diff)
        dec_errs, dec_inputs = check_decoders(scores, betas, logz, bp,
                                              v_final, labels, nb, sl)
        results.update(check_r10_wide_path(dev))
        results["head_err"] = max(check_crf_head(k) for k in HEAD_SHAPES)

        # -- 3. the model against the plain CPU path, small input --------
        small = batch[:2].float()
        sc_gpu = model(small, compute_dtype=torch.float32)
        sc_cpu = cpu_model(small.cpu(), compute_dtype=torch.float32)
        sc_err = (sc_gpu.cpu() - sc_cpu).abs().max().item()
        lab_gpu = crf_cuda.decode_paths_cuda(sc_gpu, nb, sl).cpu()
        lab_cpu = crf.decode_paths(sc_cpu, nb, sl)
        lab_diff = (lab_gpu != lab_cpu).float().mean().item()
        print(f"f32 model on the card vs the plain CPU path, 2 chunks: "
              f"scores max_abs {sc_err:.3e} (tolerance 1e-3), label frames "
              f"differing {lab_diff:.3e} (tolerance 1e-2)")
        if sc_err > 1e-3 or lab_diff > 1e-2:
            fail("the model on the card disagrees with the CPU path")
        check_quantized_model(model, cpu_model, codes, scores)

    # -- 4. the main path, through run_basecaller -----------------------
    wrappers = {"K1": lstm_cuda.lstm_recurrence,
                "K2a": crf_cuda.backward_scan,
                "K2b": crf_cuda.forward_viterbi,
                "K2c": crf_cuda.viterbi_traceback,
                "K7": lstm_cuda.lstm_recurrence_int8,
                "head": crf_head.crf_head_epilogue}
    zero_launches(wrappers)
    _build.launches["crf_head_epilogue.tiled"] = 0
    fastq = io.StringIO()
    stats = run_basecaller(model, iter(reads), fastq, chunksize=chunksize,
                           overlap=overlap, batchsize=batchsize)
    launches = launch_counts(wrappers)
    print(f"main path: {stats} launches {launches} "
          f"(batches {n_batches})")
    need = {"K1": enc.num_rnn_layers * n_batches, "K2a": n_batches,
            "K2b": n_batches, "K2c": n_batches, "head": n_batches}
    for k, n in need.items():
        if launches[k] < n:
            fail(f"{k} launched {launches[k]} times on the main path, "
                 f"expected {n}")
    if _build.launches["crf_head_epilogue.tiled"] != launches["head"]:
        fail(f"the head's kernel took its tiled path "
             f"{_build.launches['crf_head_epilogue.tiled']} of "
             f"{launches['head']} times on the main path")
    lines = fastq.getvalue().split("\n")
    seqs = lines[1::4]
    if stats["reads"] != N_READS or len(seqs) != N_READS \
            or not all(seqs) or not all(set(s) <= set("ACGTXY")
                                        for s in seqs):
        fail("the main path did not return one non-empty sequence per read")
    print(f"pipeline: {stats['samples_per_s']:.4e} samples/s on {card}")

    # -- 4b. the quantized path, through run_basecaller(quantize=True) --
    zero_launches(wrappers)
    fastq_q = io.StringIO()
    stats_q = run_basecaller(model, iter(reads), fastq_q, chunksize=chunksize,
                             overlap=overlap, batchsize=batchsize,
                             quantize=True)
    q_launches = launch_counts(wrappers)
    print(f"quantized path: {stats_q} launches {q_launches} "
          f"(batches {n_batches})")
    need = {"K7": enc.num_rnn_layers * n_batches, "K1": 0,
            "K2a": n_batches, "K2b": n_batches, "K2c": n_batches,
            "head": n_batches}
    for k, n in need.items():
        if q_launches[k] != n:
            fail(f"{k} launched {q_launches[k]} times on the quantized path, "
                 f"expected {n}")
    seqs = fastq_q.getvalue().split("\n")[1::4]
    if stats_q["reads"] != N_READS or len(seqs) != N_READS \
            or not all(seqs) or not all(set(s) <= set("ACGTXY")
                                        for s in seqs):
        fail("the quantized path did not return one non-empty sequence per "
             "read")
    print(f"quantized pipeline: {stats_q['samples_per_s']:.4e} samples/s on "
          f"{card}")

    # -- 4c. the q-score and beam decodes, through run_basecaller -------
    dec_wrappers = {"K1": lstm_cuda.lstm_recurrence,
                    "K2a": crf_cuda.backward_scan,
                    "K2b": crf_cuda.forward_viterbi,
                    "K2c": crf_cuda.viterbi_traceback,
                    "K2b-qual": crf_cuda.forward_viterbi_qual,
                    "K2c-qual": crf_cuda.viterbi_traceback_qual,
                    "K4": crf_cuda.forward_scan,
                    "beam": crf_cuda.beam_search}
    dec_launches = {}
    for path, opts, need in (
            ("qscores", {"qscores": True},
             {"K2a": 1, "K2b-qual": 1, "K2c-qual": 1, "K2b": 0, "K2c": 0,
              "K4": 0, "beam": 0}),
            (f"beam {PIPELINE_BEAM}", {"beam_width": PIPELINE_BEAM},
             {"K4": 1, "K2a": 1, "beam": 1, "K2b": 0, "K2c": 0,
              "K2b-qual": 0, "K2c-qual": 0})):
        zero_launches(dec_wrappers)
        fq = io.StringIO()
        st = run_basecaller(model, iter(reads), fq, chunksize=chunksize,
                            overlap=overlap, batchsize=batchsize, **opts)
        got = launch_counts(dec_wrappers)
        print(f"{path} path: {st} launches {got} (batches {n_batches})")
        need = {"K1": enc.num_rnn_layers, **need}
        for k, per_batch in need.items():
            if got[k] != per_batch * n_batches:
                fail(f"{k} launched {got[k]} times on the {path} path, "
                     f"expected {per_batch * n_batches}")
        dec_launches[path] = got
        lines = fq.getvalue().split("\n")
        seqs, quals = lines[1::4], lines[3::4]
        if st["reads"] != N_READS or len(seqs) != N_READS or not all(seqs) \
                or not all(set(q) <= set("ACGTXY") for q in seqs) \
                or any(len(q) != len(q_s) for q, q_s in zip(seqs, quals)) \
                or not all(33 <= ord(c) <= 126 for q in quals for c in q):
            fail(f"the {path} path did not return one sequence per read "
                 "with a valid qstring of its length")
        if path == "qscores":
            from xna_basecaller_tpu_torch.data.writers import (
                mean_qscore_from_qstring,
            )
            mean_q = statistics.mean(mean_qscore_from_qstring(q)
                                     for q in quals)
            qs = sorted({ord(c) - 33 for q in quals for c in q})
            print(f"qscores path: mean q of the reads {mean_q:.3f}, q values "
                  f"{qs}; {st['samples_per_s']:.4e} samples/s on {card}")
        else:
            same = sum(a == b for a, b in zip(
                seqs, fastq.getvalue().split("\n")[1::4]))
            print(f"{path} path: {same} of {N_READS} reads called as the "
                  f"Viterbi path calls them; {st['samples_per_s']:.4e} "
                  f"samples/s on {card}")

    # -- 4d. superbatches, through run_basecaller(superbatch=2) ---------
    drive_superbatches(model, reads, fastq.getvalue(), cfg, n_batches,
                       card)
    # -- 4e. a reference-format checkpoint, the sharded scorer ---------
    drive_model_io(model, cfg, chunks[:batchsize], card)

    # -- 5.-8. the training path -----------------------------------------
    sim = simulate_ctc_dataset(TRAIN_BATCH, chunk_len=chunksize,
                               target_len=400, seed=SEED + 1)
    tbatch = tuple(torch.from_numpy(a.astype(dt)).to(dev) for a, dt in zip(
        sim[:3], (np.float32, np.int64, np.int64)))
    k3_errs, k3_inputs = check_trainable_kernels(model, *tbatch)
    loss_errs, loss_inputs = check_loss_kernels(model, *tbatch)
    check_step_against_cpu()
    workroot = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "runs", "chip_smoke")
    shutil.rmtree(workroot, ignore_errors=True)
    try:
        train_launches, train_steps, step_s = drive_training(workroot)
        # -- 8b. the training path with both augmentations ---------------
        donor_tables = drive_augmented_training(workroot)
        # -- 8e. the train CLI under torch.distributed.run (NCCL) --------
        drive_distributed_training(workroot, card)
        # -- 8c. phase B (bootstrap data) on the card, feeding phase C ---
        drive_bootstrap_data(workroot, model, cfg, reads, card)
        # -- 8d. the north-star chain A -> E (tools/spliced_northstar) --
        drive_northstar(workroot, card)
        boot_dir = os.path.join(workroot, "northstar", "bootstrap_model")
        # -- 8f. the legacy CTC (QuartzNet) family ---------------------
        drive_ctc_family(workroot, reads, card)
        # -- 8g. modified bases (basecaller --mods-model) ---------------
        mods_launches = drive_mods(workroot, boot_dir, card)
        # -- 8h. duplex pairs (xnacall duplex --pair-decode) ------------
        duplex_f32, duplex_launches = drive_duplex(workroot, boot_dir, card)
        # -- 8i. evaluate, view, export ----------------------------------
        eval_launches = drive_evaluate_view_export(workroot, boot_dir, card)
        # -- 8j. download, convert, comp_basecalls_perf, forensics ------
        tail_launches = drive_tail(workroot, boot_dir, reads, card)
        print(f"launches of the new paths: mods {mods_launches}, duplex "
              f"read_transition_probs {duplex_f32}, duplex CLI "
              f"{duplex_launches}, evaluate {eval_launches}, installed "
              f"models {tail_launches}")
    finally:
        shutil.rmtree(workroot, ignore_errors=True)
    print(f"training path step times (host clock, losses_1.csv): "
          f"{[round(float(v) * 1e3, 1) for v in step_s]} ms")

    # -- 9. timing at the main paths' shapes -----------------------------
    T, N = scores.shape[:2]
    H = enc.features
    ns = cfg.n_state
    p = layer0.params(torch.bfloat16)
    xp, w_hh = k1_inputs
    xb = x.to(torch.bfloat16)
    # the LSTM kernels, their yardsticks and the rows sweep in one window
    with CardSampler() as sampler:
        timings = lstm_yardsticks(model, k3_inputs, k1_inputs, xb, x, card,
                                  baseline)
        rows_sweep(card)
    print(f"card during the LSTM window: {sampler.summary}")
    with torch.inference_mode():
        xq, w_q, scale_q, w_hh_q, rev_q = k7_inputs
        w_hh_b = w_hh_q.to(torch.bfloat16).contiguous()
        fns = {"K7": lambda: lstm_cuda.lstm_recurrence_int8(
                   xq, w_q, scale_q, rev_q),
               "K1 on K7's xp (bf16 W_hh)": lambda: lstm_cuda.lstm_recurrence(
                   xq, w_hh_b, rev_q)}
        if baseline:
            fns["K7 of the baseline tree"] = lambda: baseline["K7"](
                xq, w_q, scale_q, rev_q)
        k7_t = in_turns(fns)
        print("time K7 at the basecall batch, medians of 21 in turns: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in k7_t.items())
              + f" on {card}")
        timings["K7"] = (
            k7_t["K7"],
            elapsed_ms(lambda: lstm.lstm_recurrence_int8(
                xq, w_q, scale_q, rev_q), 1), None)

        k_ms, chain_ms = time_crf_head(card)["XNA"]
        timings["head"] = (k_ms, chain_ms, None)
        scan_t = crf_scan_turns(scores, loss_inputs[0], loss_inputs[5:],
                                nb, sl, card, baseline)
        for k, v in scan_t.items():
            timings[k] = (*v, None)
        dec_t = time_decoders(model, batch, scores, betas, logz, dec_inputs,
                              nb, sl, card, baseline)
        for k, v in dec_t.items():
            timings[k] = (*v, None)

        # the batch's other stages, for the breakdown of its time
        timings["conv stack (f32)"] = elapsed_ms(
            lambda: conv_stack_forward(model.conv, batch.float()[:, None, :],
                                       enc.activation), 3)
        timings["input projection (one layer)"] = elapsed_ms(
            lambda: lstm.input_projection(p, xb), 5)
        timings["CRF head"] = elapsed_ms(
            lambda: crf_head_forward(model.head, model.head_ext, xb, cfg), 5)
        timings["decode (K2a + logZ + K2b + K2c)"] = elapsed_ms(
            lambda: crf_cuda.decode_paths_cuda(scores, nb, sl), 5)

        def batch_on_device():
            sc = model(batch)
            return crf_cuda.decode_paths_cuda(sc, nb, sl)
        t_batch = elapsed_ms(batch_on_device, 3)
        timings["batch (model + decode)"] = t_batch

        # the quantized batch's own stages
        timings["int8 input projection (one layer: quantize w_ih, "
                "int8_matmul, bias)"] = elapsed_ms(
            lambda: (lstm.int8_matmul(xb, *lstm.quantize_w_hh(p["w_ih"]))
                     + p["bias"]).to(torch.bfloat16), 5)
        timings["int8 head product (quantize w, int8_matmul)"] = elapsed_ms(
            lambda: lstm.int8_matmul(xb, *lstm.quantize_w_hh(
                model.head.w.to(torch.bfloat16))), 5)
        timings["int8 CRF head (products + f32 epilogue)"] = elapsed_ms(
            lambda: crf_head_forward(model.head, model.head_ext, xb, cfg,
                                     int8=True), 5)
        timings["quantized conv stack (dequantize + f32 conv)"] = elapsed_ms(
            lambda: conv_stack_forward(
                model.conv,
                (codes.float() * (1.0 / QUANT_SCALE))[:, None, :],
                enc.activation), 3)

        def quantized_batch_on_device():
            sc = model(codes, lstm_int8=True)
            return crf_cuda.decode_paths_cuda(sc, nb, sl)
        t_qbatch = elapsed_ms(quantized_batch_on_device, 3)
        timings["quantized batch (model + decode)"] = t_qbatch
    steady = run_basecaller(model, iter(reads * 4), io.StringIO(),
                            chunksize=chunksize, overlap=overlap,
                            batchsize=batchsize)
    steady_q = run_basecaller(model, iter(reads * 4), io.StringIO(),
                              chunksize=chunksize, overlap=overlap,
                              batchsize=batchsize, quantize=True)
    steady_dec = {path: run_basecaller(
        model, iter(reads * 4), io.StringIO(), chunksize=chunksize,
        overlap=overlap, batchsize=batchsize, **opts)
        for path, opts in (("--qscores", {"qscores": True}),
                           (f"--beam {PIPELINE_BEAM}",
                            {"beam_width": PIPELINE_BEAM}))}
    for k, v in timings.items():
        print(f"time {k}: {v} ms on {card}")
    t_train = time_training(model, tbatch, loss_inputs, card)
    timings["K5b"] = (*t_train["K5b"], None)
    time_augmentation(model, sim, donor_tables, card)
    print(f"device-only: {batchsize * chunksize / t_batch * 1e3:.4e} "
          f"samples/s ({t_batch:.3f} ms per batch of {batchsize} x "
          f"{chunksize}) on {card}")
    print(f"pipeline, same reads x4 "
          f"({math.ceil(4 * len(chunks) / batchsize)} batches): "
          f"{steady['samples_per_s']:.4e} samples/s on {card}")
    print(f"quantized device-only: "
          f"{batchsize * chunksize / t_qbatch * 1e3:.4e} samples/s "
          f"({t_qbatch:.3f} ms per batch of {batchsize} x {chunksize}) on "
          f"{card}")
    print(f"quantized pipeline, same reads x4: "
          f"{steady_q['samples_per_s']:.4e} samples/s on {card}")
    for path, st in steady_dec.items():
        print(f"pipeline {path}, same reads x4: {st['samples_per_s']:.4e} "
              f"samples/s on {card}")

    # bounds from this run's shapes; ops counted per state and step
    C = scores.shape[2]
    xp3, w3, _, ys3, _, _ = k3_inputs
    Tt, Nt, _ = ys3.shape
    # K3a: xp + W_hh + ys + cs, one [N,H]x[H,4H] product per step
    b_k3a = bound(2 * (xp3.numel() + w3.numel() + 2 * ys3.numel()),
                  2.0 * Tt * Nt * H * 4 * H, PEAK_BF16)
    # K3b: dy, h, c_prev, c + xp + dxp + W_hh; the recompute and the carry
    b_k3b = bound(2 * (4 * ys3.numel() + 2 * xp3.numel() + w3.numel()),
                  4.0 * Tt * Nt * H * 4 * H, PEAK_BF16)
    b_k1 = bound(2 * (xp.numel() + w_hh.numel() + T * N * H),
                 2.0 * T * N * H * 4 * H, PEAK_BF16)
    # K1's f32 route at duplex's rows: xp, W_hh and ys in f32
    n32 = DUPLEX_K1_ROWS[0]
    b_k1f = bound(4 * (T * n32 * 4 * H + w_hh.numel() + T * n32 * H),
                  2.0 * T * n32 * H * 4 * H, PEAK_F32)
    # K7: xp and ys in bf16, W_q int8, scale f32; the int8 product per step
    b_k7 = bound(2 * (xq.numel() + T * N * H) + w_q.numel()
                 + 4 * scale_q.numel(), 2.0 * T * N * H * 4 * H, PEAK_INT8)
    # lse over n_base moves (5 ops each + log, add) and the stay pair (~11)
    b_k2a = bound(4 * (T * N * C + (T + 1) * N * ns),
                  T * N * ns * (5 * nb + 13), PEAK_F32)
    # 7 edges x 7 ops, 7 compares, alpha lse over 7 (4 ops each + 2)
    b_k2b = bound(4 * (T * N * C + T * N * ns + N + N * ns) + T * N * ns,
                  T * N * ns * (7 * 7 + 7 + 4 * 7 + 2), PEAK_F32)
    # one backpointer byte per frame along each path, v_final, the labels
    b_k2c = bound(T * N + 4 * N * ns + T * N, N * (ns + 3 * T), PEAK_F32)
    # the q-score K2b: K2b's bytes and the f32 edge_sel [T, N, ns] written
    b_k2bq = bound(4 * (T * N * C + T * N * ns + N + N * ns) + T * N * ns
                   + 4 * T * N * ns, T * N * ns * (7 * 7 + 7 + 4 * 7 + 2),
                   PEAK_F32)
    # the q-score K2c: K2c's bytes, an edge_sel element per frame read and
    # the f32 probs written; an exp per frame more
    b_k2cq = bound(T * N + 4 * N * ns + T * N + 8 * T * N,
                   N * (ns + 4 * T), PEAK_F32)
    # the beam at B = PIPELINE_BEAM: per step and row, the candidates'
    # scores and betas and one alpha a beam, logZ; labels and best_score
    # written; per candidate its edge (4 adds), its score, an exp in the
    # merge, and the pairwise merge and rank compares of the candidates
    M = PIPELINE_BEAM * (nb + 1)
    b_beam = bound(4 * T * N * (2 * M + PIPELINE_BEAM) + 4 * N + T * N
                   + 4 * N, T * N * (6 * M + 2 * M * M), PEAK_F32)
    # the loss kernels at the training shapes
    n_lat = loss_inputs[5].shape[2]
    # K4: alpha lse over 7 (add, max, sub, exp, sum each + log, add)
    b_k4 = bound(4 * (Tt * Nt * C + (Tt + 1) * Nt * ns + Nt),
                 Tt * Nt * ns * (5 * (nb + 1) + 2), PEAK_F32)
    b_k5a = bound(4 * (Tt * Nt * C + (Tt + 1) * Nt * ns),
                  Tt * Nt * ns * (5 * nb + 13), PEAK_F32)
    # K5b: scores, alphas_t, betas_{t+1}, logZ, ct in, posteriors out;
    # three adds, exp and the multiply per edge
    b_k5b = bound(4 * (2 * Tt * Nt * C + 2 * Tt * Nt * ns + 2 * Nt),
                  5 * Tt * Nt * C, PEAK_F32)
    lat = Tt * Nt * n_lat
    # K6a: stay, move, lengths in, alphas, logZ out; a two-way lse (10 ops)
    b_k6a = bound(4 * (3 * lat - Tt * Nt + 2 * Nt), 10 * lat, PEAK_F32)
    # K6b: stay, move, alphas, lengths, logZ, ct in, d_stay, d_move out;
    # two posteriors (5 ops each) and a logaddexp (9)
    b_k6b = bound(4 * (5 * lat - 2 * Tt * Nt + 3 * Nt), 19 * lat, PEAK_F32)
    meta = {
        "K1": ("lstm_recurrence", "lstm_recurrence.cu",
               "xna_basecaller_tpu/ops/lstm_pallas.py:92", b_k1,
               results["K1_bf16_err"]),
        # the same Pallas kernel in f32 (an f32 h scratch,
        # lstm_pallas.py:145-147): its f32 route, at duplex's rows
        "K1-f32": (f"lstm_f32_kernel (K1's f32 route, N={n32})",
                   "lstm_recurrence.cu",
                   "xna_basecaller_tpu/ops/lstm_pallas.py:92", b_k1f,
                   results["K1-f32_err"]),
        "K2a": ("crf_backward", "crf_decode.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:101", b_k2a,
                results["K2a_err"]),
        "K2b": ("crf_fwd_viterbi", "crf_decode.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:216", b_k2b,
                results["K2b_err"]),
        "K2c": ("crf_traceback", "crf_decode.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:257", b_k2c,
                results["K2c_err"]),
        "K3a": ("lstm_forward_with_cells", "lstm_recurrence.cu",
                "xna_basecaller_tpu/ops/lstm_pallas.py:329", b_k3a,
                k3_errs["K3a"]),
        "K3b": ("lstm_backward", "lstm_backward.cu",
                "xna_basecaller_tpu/ops/lstm_pallas.py:409", b_k3b,
                k3_errs["K3b"]),
        "K4": ("crf_forward", "crf_loss.cu",
               "xna_basecaller_tpu/ops/crf_pallas.py:77", b_k4,
               loss_errs["K4"]),
        "K5a": ("crf_backward_kernel (K2a's kernel)", "crf_decode.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:89", b_k5a,
                loss_errs["K5a"]),
        "K5b": ("crf_posterior", "crf_loss.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:415", b_k5b,
                loss_errs["K5b"]),
        "K6a": ("lattice_forward", "crf_loss.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:466", b_k6a,
                loss_errs["K6a"]),
        "K6b": ("lattice_backward", "crf_loss.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:487", b_k6b,
                loss_errs["K6b"]),
        "K7": ("lstm_recurrence_int8", "lstm_int8.cu",
               "xna_basecaller_tpu/ops/lstm_pallas.py:221", b_k7, k7_err),
        # the q-score variants of K2b and K2c: JAX's q-score decode is XLA
        # (ops/crf.py::decode_paths_with_qual)
        "K2b-qual": ("crf_fwd_viterbi<QUAL> (K2b's q-score variant)",
                     "crf_decode.cu", "xna_basecaller_tpu/ops/crf.py:806",
                     b_k2bq, dec_errs["K2b-qual"]),
        "K2c-qual": ("crf_traceback<QUAL> (K2c's q-score variant)",
                     "crf_decode.cu", "xna_basecaller_tpu/ops/crf.py:806",
                     b_k2cq, dec_errs["K2c-qual"]),
        # no Pallas counterpart: JAX runs the beam search as XLA
        "beam": (f"crf_beam (B={PIPELINE_BEAM})", "crf_beam.cu",
                 "xna_basecaller_tpu/ops/crf.py:629", b_beam,
                 dec_errs["beam"]),
        # no Pallas counterpart: XLA fuses the head's epilogue in JAX
        # (models/crf_model.py); its plain_ms is the chain it replaced, at
        # the XNA head, whose launches phase 4 counts (R10's time is
        # printed by time_crf_head)
        "head": ("crf_head_epilogue (XNA head {} x {} x {})".format(
                     *HEAD_SHAPES["XNA"][:2], HEAD_SHAPES["XNA"][3]),
                 "crf_head.cu", "xna_basecaller_tpu/models/crf_model.py:78",
                 head_bound(*HEAD_SHAPES["XNA"]), results["head_err"]),
    }
    launches.update({k: train_launches[k] for k in (
        "K3a", "K3b", "K4", "K5b", "K6a", "K6b")})
    launches["K5a"] = train_launches["K2a"]
    launches["K7"] = q_launches["K7"]
    launches["K2b-qual"] = dec_launches["qscores"]["K2b-qual"]
    launches["K2c-qual"] = dec_launches["qscores"]["K2c-qual"]
    launches["beam"] = dec_launches[f"beam {PIPELINE_BEAM}"]["beam"]
    # K1's f32 route on its path: duplex --pair-decode (phase 8h)
    launches["K1-f32"] = duplex_launches["K1-f32"]
    if not launches["K1-f32"]:
        fail("duplex --pair-decode did not launch K1's f32 route")
    kernels = []
    for k, (name, src, replaces, (b_ms, b_by), err) in meta.items():
        ms, plain_ms, lib_ms = timings[k]
        kernels.append({
            "name": f"{k} {name}", "route": "cuda",
            "source": f"xna_basecaller_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    print(f"whole run: {time.perf_counter() - t_run:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
