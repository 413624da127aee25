#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``xna_basecaller_tpu_torch``) on one NVIDIA
GPU, at the full width of the flagship model (conv 768, 5 x LSTM(768),
1512-column CRF, chunks of 3600, batch 256; random weights from a seed).

Phases, each of which fails the run (non-zero exit) if it fails:
  1. print the card's name and power limit, build every kernel in
     ``xna_basecaller_tpu_torch/csrc`` (nvcc, in parallel) and print the
     build log with the ptxas register and spill lines;
  2. hold each kernel against its plain PyTorch version on the card, on the
     tensors the main path gives it for one batch of simulated reads:
     K1 (LSTM recurrence) in bf16 and f32, K2a/K2b/K2c (CRF decode);
  3. check the model's scores and labels against the plain CPU path on a
     small input;
  4. set every launch count to 0, basecall simulated reads through
     ``infer.basecall.run_basecaller``, read the counts, check every read;
  5. time each kernel, its plain version and its library yardstick with
     CUDA events, the batch's other stages (conv, input projection, head,
     decode), one batch through model and decode, and the pipeline's
     samples/s over the same reads four times;
  6. print the ``kernels`` JSON line, then the result line.

Run from the repository root:  python3 chip_smoke.py
Without a CUDA device (or without the package beside it) it exits non-zero
and prints no result.
"""

from __future__ import annotations

import io
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

N_READS, MEAN_LEN, SEED = 16, 120_000, 0


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


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from xna_basecaller_tpu_torch.core.config import ModelConfig
    from xna_basecaller_tpu_torch.data import chunkops
    from xna_basecaller_tpu_torch.data.simulate import simulate_reads
    from xna_basecaller_tpu_torch.infer.basecall import run_basecaller
    from xna_basecaller_tpu_torch.models.crf_model import (
        Model, crf_head_forward,
    )
    from xna_basecaller_tpu_torch.ops import _build, crf, crf_cuda, lstm
    from xna_basecaller_tpu_torch.ops import lstm_cuda
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
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print(_build.build_log())

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
            results[f"K1_{name}_err"] = err.max().item()
            if name == "bf16":
                k1_inputs = (xp, p["w_hh"])

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

    # -- 4. the main path, through run_basecaller -----------------------
    wrappers = {"K1": lstm_cuda.lstm_recurrence,
                "K2a": crf_cuda.backward_scan,
                "K2b": crf_cuda.forward_viterbi,
                "K2c": crf_cuda.viterbi_traceback}
    for w in wrappers.values():
        w.launches = 0
    fastq = io.StringIO()
    stats = run_basecaller(model, iter(reads), fastq, chunksize=chunksize,
                           overlap=overlap, batchsize=batchsize)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"main path: {stats} launches {launches} "
          f"(batches {n_batches})")
    need = {"K1": enc.num_rnn_layers * n_batches, "K2a": n_batches,
            "K2b": n_batches, "K2c": n_batches}
    for k, n in need.items():
        if launches[k] < n:
            fail(f"{k} launched {launches[k]} times on the main path, "
                 f"expected {n}")
    lines = fastq.getvalue().split("\n")
    seqs = lines[1::4]
    if stats["reads"] != N_READS or len(seqs) != N_READS \
            or not all(seqs) or not all(set(s) <= set("ACGTXY")
                                        for s in seqs):
        fail("the main path did not return one non-empty sequence per read")
    print(f"pipeline: {stats['samples_per_s']:.4e} samples/s on {card}")

    # -- 5. timing at the main path's shapes ------------------------------
    T, N = scores.shape[:2]
    H = enc.features
    ns = cfg.n_state
    timings = {}
    p = layer0.params(torch.bfloat16)
    ref = torch.nn.LSTM(H, H).to(dev, torch.bfloat16)   # yardstick only
    with torch.no_grad():
        ref.weight_ih_l0.copy_(p["w_ih"].T)
        ref.weight_hh_l0.copy_(p["w_hh"].T)
        ref.bias_ih_l0.copy_(p["bias"])
        ref.bias_hh_l0.zero_()
    # cuDNN does not flatten bf16 weights and warns on every call
    warnings.filterwarnings("ignore", message="RNN module weights")
    with torch.inference_mode():
        xp, w_hh = k1_inputs
        t_k1 = elapsed_ms(lambda: lstm_cuda.lstm_recurrence(xp, w_hh), 5)
        t_k1_plain = elapsed_ms(lambda: lstm.lstm_recurrence(xp, w_hh), 1)
        xb = x.to(torch.bfloat16)
        t_proj_k1 = elapsed_ms(lambda: lstm_cuda.lstm_forward(p, xb), 5)
        t_cudnn = elapsed_ms(lambda: ref(xb), 5)
        timings["K1"] = (t_k1, t_k1_plain, t_cudnn)
        timings["K1 input projection + K1"] = t_proj_k1

        timings["K2a"] = (
            elapsed_ms(lambda: crf_cuda.backward_scan(scores, nb, sl), 5),
            elapsed_ms(lambda: crf.backward_scores(scores, nb, sl), 1), None)
        timings["K2b"] = (
            elapsed_ms(lambda: crf_cuda.forward_viterbi(
                scores, betas, logz, nb, sl), 5),
            elapsed_ms(lambda: crf.forward_viterbi(
                scores, betas, logz, nb, sl), 1), None)
        timings["K2c"] = (
            elapsed_ms(lambda: crf_cuda.viterbi_traceback(
                bp, v_final, nb, sl), 10),
            elapsed_ms(lambda: crf.viterbi_traceback(
                bp, v_final, nb, sl), 1), None)

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
    steady = run_basecaller(model, iter(reads * 4), io.StringIO(),
                            chunksize=chunksize, overlap=overlap,
                            batchsize=batchsize)
    for k, v in timings.items():
        print(f"time {k}: {v} ms on {card}")
    print(f"device-only: {batchsize * chunksize / t_batch * 1e3:.4e} "
          f"samples/s ({t_batch:.3f} ms per batch of {batchsize} x "
          f"{chunksize}) on {card}")
    print(f"pipeline, same reads x4 "
          f"({math.ceil(4 * len(chunks) / batchsize)} batches): "
          f"{steady['samples_per_s']:.4e} samples/s on {card}")

    # bounds from this run's shapes; ops counted per state and step
    C = scores.shape[2]
    b_k1 = bound(2 * (xp.numel() + w_hh.numel() + T * N * H),
                 2.0 * T * N * H * 4 * H, PEAK_BF16)
    # lse over n_base moves (5 ops each + log, add) and the stay pair (~11)
    b_k2a = bound(4 * (T * N * C + (T + 1) * N * ns),
                  T * N * ns * (5 * nb + 13), PEAK_F32)
    # 7 edges x 7 ops, 7 compares, alpha lse over 7 (4 ops each + 2)
    b_k2b = bound(4 * (T * N * C + T * N * ns + N + N * ns) + T * N * ns,
                  T * N * ns * (7 * 7 + 7 + 4 * 7 + 2), PEAK_F32)
    # one backpointer byte per frame along each path, v_final, the labels
    b_k2c = bound(T * N + 4 * N * ns + T * N, N * (ns + 3 * T), PEAK_F32)
    meta = {
        "K1": ("lstm_recurrence", "lstm_recurrence.cu",
               "xna_basecaller_tpu/ops/lstm_pallas.py:92", b_k1,
               results["K1_bf16_err"]),
        "K2a": ("crf_backward", "crf_decode.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:101", b_k2a,
                results["K2a_err"]),
        "K2b": ("crf_fwd_viterbi", "crf_decode.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:216", b_k2b,
                results["K2b_err"]),
        "K2c": ("crf_traceback", "crf_decode.cu",
                "xna_basecaller_tpu/ops/crf_pallas.py:257", b_k2c,
                results["K2c_err"]),
    }
    kernels = []
    for k, (name, src, replaces, (b_ms, b_by), err) in meta.items():
        ms, plain_ms, lib_ms = timings[k]
        kernels.append({
            "name": f"{k} {name}", "route": "cuda",
            "source": f"xna_basecaller_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
