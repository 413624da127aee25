#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``xna_basecaller_tpu_torch``) on one NVIDIA
GPU, at the full width of the flagship model (conv 768, 5 x LSTM(768),
1512-column CRF, chunks of 3600; random weights from a seed): its two
paths, basecalling (batch 256) and training (batch 64).

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
  5. hold K3a (trainable LSTM forward) and K3b (its backward recursion)
     against their plain versions on the tensors of one training batch
     (T=720, N=64, H=768; layers 0 and 1, so both directions), in bf16
     and f32;
  6. one f32 training step of a small model on the card against the same
     step on the CPU (plain versions): loss, grad_norm, parameters;
  7. set every launch count to 0, train the flagship model for 8 steps
     and one validation through the ``train`` CLI on simulated ctc-data,
     read the counts, check the losses, the moved weights and that
     ``weights_1.npz`` loads back;
  8. time each kernel, its plain version and its library yardstick with
     CUDA events, the batch's other stages (conv, input projection, head,
     decode), one batch through model and decode, the pipeline's
     samples/s over the same reads four times, and one training step with
     its breakdown;
  9. print the ``kernels`` JSON line, then the result line.

Run from the repository root:  python3 chip_smoke.py
Without a CUDA device (or without the package beside it) it exits non-zero
and prints no result.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
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
TRAIN_BATCH, TRAIN_STEPS, VALID_CHUNKS = 64, 8, 16


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


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


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


def check_step_against_cpu():
    """Phase 6: one f32 training step of a small model (64 features, 2
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


def drive_training(workroot: str):
    """Phase 7: the training path through the ``train`` CLI; returns the
    launch counts of the run, the number of steps and the step times."""
    import csv
    import os

    from xna_basecaller_tpu_torch.cli import main as cli
    from xna_basecaller_tpu_torch.core.config import ModelConfig
    from xna_basecaller_tpu_torch.data.ctc_data import save_ctc_data
    from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset
    from xna_basecaller_tpu_torch.models.crf_model import Model
    from xna_basecaller_tpu_torch.ops import crf_cuda, lstm_cuda
    from xna_basecaller_tpu_torch.utils.model_io import load_model
    from xna_basecaller_tpu_torch.utils.weights import params_to_jax

    data, run = os.path.join(workroot, "data"), os.path.join(workroot, "run")
    n_train = TRAIN_STEPS * TRAIN_BATCH
    # the 97/3 split of load_datasets leaves exactly VALID_CHUNKS
    save_ctc_data(data, *simulate_ctc_dataset(
        n_train + VALID_CHUNKS, chunk_len=3600, target_len=400, seed=SEED))
    wrappers = {"K1": lstm_cuda.lstm_recurrence,
                "K2a": crf_cuda.backward_scan,
                "K2b": crf_cuda.forward_viterbi,
                "K2c": crf_cuda.viterbi_traceback,
                "K3a": lstm_cuda.lstm_forward_with_cells,
                "K3b": lstm_cuda.lstm_backward_dxp}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    cli(["train", run, "--directory", data, "--epochs", "1", "--batch",
         str(TRAIN_BATCH), "--seed", str(SEED), "--device", "cuda", "-f"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
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
    n_layers = ModelConfig().encoder.num_rnn_layers
    need = {"K3a": n_layers * steps, "K3b": n_layers * steps,
            "K1": n_layers, "K2a": 1, "K2b": 1, "K2c": 1}
    for k, n in need.items():
        if launches[k] < n:
            fail(f"{k} launched {launches[k]} times on the training path, "
                 f"expected at least {n}")
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


def time_training(model, batch, keep, card):
    """Phase 8 (training side): K3a and K3b with their plain versions and
    torch.nn.LSTM's training forward and backward as yardsticks, the
    port's layer forward and backward, and one training step with its
    breakdown."""
    from xna_basecaller_tpu_torch.ops import lstm, lstm_cuda
    from xna_basecaller_tpu_torch.train.loop import (
        make_optimizer, train_step,
    )

    xp, w, dys, ys, cs, rev = keep
    t = {}
    with torch.no_grad():
        t["K3a"] = (
            elapsed_ms(lambda: lstm_cuda.lstm_forward_with_cells(xp, w, rev),
                       5),
            elapsed_ms(lambda: lstm.lstm_recurrence_with_cells(xp, w, rev),
                       1))
        t["K3b"] = (
            elapsed_ms(lambda: lstm_cuda.lstm_backward_dxp(
                dys, xp, w, ys, cs, rev), 5),
            elapsed_ms(lambda: lstm.lstm_backward_dxp(
                dys, xp, w, ys, cs, rev), 1))
    T, N, H = ys.shape
    chunks, targets, lengths = batch
    x = torch.randn(T, N, H, device="cuda", dtype=torch.bfloat16,
                    generator=torch.Generator("cuda").manual_seed(SEED))
    x.requires_grad_()
    ref = torch.nn.LSTM(H, H).to("cuda", torch.bfloat16).train()
    out, _ = ref(x)
    t["nn.LSTM training forward"] = elapsed_ms(lambda: ref(x), 5)
    t["nn.LSTM backward"] = elapsed_ms(
        lambda: out.backward(dys, retain_graph=True), 5)
    p = model.rnn[0].params(torch.bfloat16)
    t["projection + K3a"] = elapsed_ms(
        lambda: lstm_cuda.lstm_forward_trainable(p, x, rev), 5)

    def layer_fwd_bwd():
        lstm_cuda.lstm_forward_trainable(p, x, rev).backward(dys)
    t["projection + K3a + K3b + dW + projection backward"] = elapsed_ms(
        layer_fwd_bwd, 3)

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
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) / 3 * 1e3
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
             "loss forward + backward (plain torch)": t_loss,
             "model backward (head, 5 x (K3b + dW + projection backward), "
             "conv)": t_fwd_bwd - t_fwd,
             "optimizer (clip + AdamW)": t_opt}
    for k, v in {**{f"{k} (ms, plain ms)": v for k, v in t.items()
                    if k in ("K3a", "K3b")},
                 **{k: v for k, v in t.items()
                    if k not in ("K3a", "K3b")}}.items():
        print(f"time {k}: {v} ms on {card}")
    print(f"train step: {t_step:.3f} ms (host clock, 3 steps) on {card}; "
          "parts by CUDA events: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in parts.items())
          + f", sum {sum(parts.values()):.3f} ms")
    print(f"training: {n_samples / t_step * 1e3:.4e} samples/s "
          f"({chunks.shape[0]} x {chunks.shape[1]} per step) on {card}")
    return t


def main() -> int:
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

    # -- 5.-7. the training path -----------------------------------------
    sim = simulate_ctc_dataset(TRAIN_BATCH, chunk_len=chunksize,
                               target_len=400, seed=SEED + 1)
    tbatch = tuple(torch.from_numpy(a.astype(dt)).to(dev) for a, dt in zip(
        sim[:3], (np.float32, np.int64, np.int64)))
    k3_errs, k3_inputs = check_trainable_kernels(model, *tbatch)
    check_step_against_cpu()
    workroot = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "runs", "chip_smoke")
    shutil.rmtree(workroot, ignore_errors=True)
    try:
        train_launches, train_steps, step_s = drive_training(workroot)
    finally:
        shutil.rmtree(workroot, ignore_errors=True)
    print(f"training path step times (host clock, losses_1.csv): "
          f"{[round(float(v) * 1e3, 1) for v in step_s]} ms")

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
    t_train = time_training(model, tbatch, k3_inputs, card)
    timings["K3a"] = (*t_train["K3a"], t_train["nn.LSTM training forward"])
    timings["K3b"] = (*t_train["K3b"], t_train["nn.LSTM backward"])
    print(f"device-only: {batchsize * chunksize / t_batch * 1e3:.4e} "
          f"samples/s ({t_batch:.3f} ms per batch of {batchsize} x "
          f"{chunksize}) on {card}")
    print(f"pipeline, same reads x4 "
          f"({math.ceil(4 * len(chunks) / batchsize)} batches): "
          f"{steady['samples_per_s']:.4e} samples/s on {card}")

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
        "K3a": ("lstm_forward_with_cells", "lstm_recurrence.cu",
                "xna_basecaller_tpu/ops/lstm_pallas.py:329", b_k3a,
                k3_errs["K3a"]),
        "K3b": ("lstm_backward", "lstm_backward.cu",
                "xna_basecaller_tpu/ops/lstm_pallas.py:409", b_k3b,
                k3_errs["K3b"]),
    }
    launches.update({k: train_launches[k] for k in ("K3a", "K3b")})
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
