#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``xna_basecaller_tpu_torch``) on one NVIDIA
GPU, at the full width of the flagship model (conv 768, 5 x LSTM(768),
1512-column CRF, chunks of 3600; random weights from a seed): its three
paths, basecalling (batch 256), the int8 ``--quantize`` basecall (batch
256) and training (batch 64).

Phases, each of which fails the run (non-zero exit) if it fails:
  1. print the card's name and power limit, build every kernel in
     ``xna_basecaller_tpu_torch/csrc`` (nvcc, in parallel) and print the
     build log with the ptxas register and spill lines;
  2. hold each kernel against its plain PyTorch version on the card, on the
     tensors the main path gives it for one batch of simulated reads:
     K1 (LSTM recurrence) in bf16 and f32, K7 (the int8 recurrence, layer
     0 of the quantized path) in bf16 and f32, K2a/K2b/K2c (CRF decode);
  3. check the model's scores and labels against the plain CPU path on a
     small input, in f32 and quantized; the quantized model's scores
     against the bf16 model's on one batch; ``int8_matmul`` (cuBLASLt)
     against the CPU;
  4. set every launch count to 0, basecall simulated reads through
     ``infer.basecall.run_basecaller``, read the counts, check every read;
     then the same with ``quantize=True`` (K7 five times a batch, K1 not
     at all);
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
  9. time each kernel, its plain version and its library yardstick with
     CUDA events: K1, K3a and K3b beside the port's like-for-like layer
     and cuDNN's ``nn.LSTM`` (flattened weights) as medians of 21 calls
     taken in turns, with the card's clock and power sampled beside them,
     and the rows sweep of the LSTM kernels K1, K3a, K3b and K7 (per-step
     time = a + b x rows, over N <= 64 and over 128-256 rows); K7 beside
     K1 on K7's input (bf16 W_hh) as medians of 21 in turns; with
     ``--baseline DIR``, the K1 and K7 of that tree in the same turns; the
     CRF scans K2a at the basecall batch, K5a, K4, the lattice's K6a and
     K6b at the training batch and K6a at the validation batch's 16 rows
     as medians of 21 samples of 10 calls (with ``--baseline DIR``, in
     turns with that tree's kernels, whose betas, alphas, logZ, d_stay and
     d_move they must equal bit for bit), with the time a step, and the
     other CRF kernels (K2b, K2c, K5b) by the same statistic; the batch's
     other stages (conv, input projection, head, decode; for the quantized
     batch the int8 projection and the int8 head), one batch through model and
     decode, the pipeline's samples/s over the same reads four times, both
     unquantized and quantized, and one training step with its breakdown;
  10. print the ``kernels`` JSON line, then the result line.

Run from the repository root:  python3 chip_smoke.py
To compare with another tree (e.g. the parent commit, unpacked with
``git archive`` into a directory that .gitignore lists) on the same card,
in the same turns:
    python3 chip_smoke.py --baseline DIR
Without a CUDA device (or without the package beside it) it exits non-zero
and prints no result.
"""

from __future__ import annotations

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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, dense int8 tensor-core OP/s, f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12

N_READS, MEAN_LEN, SEED = 16, 120_000, 0
TRAIN_BATCH, TRAIN_STEPS, VALID_CHUNKS = 64, 8, 16
SCAN_BURST = 10   # calls a timed sample of the CRF kernels


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
    """K2a and K4 through the C entry points of ``crf_decode`` and
    ``crf_loss`` libraries built by ``build_tree``: {"K2a": fn(scores,
    n_base, state_len) -> betas, "K4": fn(scores, n_base, state_len) ->
    (alphas, logZ)}."""
    import ctypes

    P, I = ctypes.c_void_p, ctypes.c_int
    backward = libs["crf_decode"].xna_crf_backward
    backward.argtypes = [P, P, I, I, I, I, P]
    forward = libs["crf_loss"].xna_crf_forward
    forward.argtypes = [P, P, P, I, I, I, I, P]
    backward.restype = forward.restype = ctypes.c_int

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
                          ns, stream)
        if rc:
            fail(f"{tag}: a CRF scan returned {rc}")
        return (out, logz) if is_forward else out

    return {"K2a": lambda sc, nb, sl: scan(False, sc, nb, sl),
            "K4": lambda sc, nb, sl: scan(True, sc, nb, sl)}


def baseline_kernels(root: str) -> dict:
    """K1, K7, K2a, K4, K6a and K6b of another tree of this repository
    (``--baseline DIR``, e.g. a ``git archive`` of the parent commit), to
    be timed in turns with this tree's.  Their C interface is this tree's,
    but the lattice's, which is that tree's (``lattice_kernels``); the
    scratch given K1 and K7 is large enough for either tree's layout of h.
    Returns {"K1": fn(xp, w_hh, reverse), "K7": fn(xp, w_q, scale,
    reverse)} for bf16 xp of at most 256 rows, K2a and K4 as
    ``scan_kernels`` and "lattice" as ``lattice_kernels``."""
    import ctypes

    libs = build_tree(root, ("lstm_recurrence", "lstm_int8", "crf_decode",
                             "crf_loss"), "baseline")
    fns = {}
    for name, entry in (("lstm_recurrence", "xna_lstm_recurrence"),
                        ("lstm_int8", "xna_lstm_int8")):
        fn = getattr(libs[name], entry)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def launch(name, xp, w, scale, reverse, h_dtype):
        T, N, H4 = xp.shape
        H = H4 // 4
        ys = torch.empty(T, N, H, dtype=xp.dtype, device=xp.device)
        hbuf = torch.zeros(2 * -(-N // 128) * 128 * -(-H // 128) * 128,
                           dtype=h_dtype, device=xp.device)
        flags = torch.zeros(H, dtype=torch.int32, device=xp.device)
        if scale is None:   # K1: xp, w_hh, ys, cs (none), hbuf, flags
            ptrs = (xp.data_ptr(), w.data_ptr(), ys.data_ptr(), None)
        else:               # K7: xp, w_q, scale, ys, hbuf, flags
            ptrs = (xp.data_ptr(), w.data_ptr(), scale.data_ptr(),
                    ys.data_ptr())
        rc = fns[name](*ptrs, hbuf.data_ptr(), flags.data_ptr(), T, N, N, H,
                       int(reverse), int(xp.dtype == torch.bfloat16),
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"the baseline tree's {name} kernel returned {rc}")
        return ys

    return {"K1": lambda xp, w, rev=False: launch(
                "lstm_recurrence", xp, w, None, rev, xp.dtype),
            "K7": lambda xp, w_q, scale, rev=False: launch(
                "lstm_int8", xp, w_q, scale, rev, torch.int8),
            **scan_kernels(libs, "the baseline tree"),
            "lattice": lattice_kernels(libs["crf_loss"], "the baseline tree")}


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

    P, I = ctypes.c_void_p, ctypes.c_int
    packed = hasattr(lib, "xna_lattice_depth")
    fwd, bwd = lib.xna_lattice_forward, lib.xna_lattice_backward
    fwd.argtypes = [P] * (4 if packed else 5) + [I, I, I, P]
    bwd.argtypes = [P] * (7 if packed else 8) + [I, I, I, P]
    fwd.restype = bwd.restype = ctypes.c_int

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
    from xna_basecaller_tpu_torch.ops import crf_cuda, lstm_cuda
    from xna_basecaller_tpu_torch.utils.model_io import load_model
    from xna_basecaller_tpu_torch.utils.weights import params_to_jax

    data, run = os.path.join(workroot, "data"), os.path.join(workroot, "run")
    n_train = TRAIN_STEPS * TRAIN_BATCH
    # the 97/3 split of load_datasets leaves exactly VALID_CHUNKS
    save_ctc_data(data, *simulate_ctc_dataset(
        n_train + VALID_CHUNKS, chunk_len=3600, target_len=400, seed=SEED))
    # K5a is K2a's kernel: one counter for both
    wrappers = {"K1": lstm_cuda.lstm_recurrence,
                "K2a": crf_cuda.backward_scan,
                "K2b": crf_cuda.forward_viterbi,
                "K2c": crf_cuda.viterbi_traceback,
                "K3a": lstm_cuda.lstm_forward_with_cells,
                "K3b": lstm_cuda.lstm_backward_dxp,
                "K4": crf_cuda.forward_scan,
                "K5b": crf_cuda.edge_posteriors,
                "K6a": crf_cuda.lattice_forward,
                "K6b": crf_cuda.lattice_backward}
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
    n_valid = math.ceil(VALID_CHUNKS / TRAIN_BATCH)
    # validation runs the loss without gradients: K4 and K6a only
    need = {"K3a": n_layers * steps, "K3b": n_layers * steps,
            "K1": n_layers * n_valid, "K2a": steps + n_valid,
            "K2b": n_valid, "K2c": n_valid, "K4": steps + n_valid,
            "K5b": steps, "K6a": steps + n_valid, "K6b": steps}
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


def lstm_yardsticks(model, keep, k1_inputs, xb, card, baseline):
    """Phase 9 (LSTM kernels): K1, K3a and K3b each beside the port's
    like-for-like layer and its cuDNN yardstick (``torch.nn.LSTM`` with
    flattened weights, layer 0's weights), as medians of 21 calls taken in
    turns in one stretch: K1 at the basecall batch (and the baseline
    tree's K1, when given), K3a and K3b at the training batch; and each
    plain version once.  Returns {kernel: (ms, plain ms, library ms)}."""
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
    for what, got in (("K1 at the basecall batch", inf),
                      ("K3a at the training batch", fwd),
                      ("K3b at the training batch", bwd)):
        print(f"time {what}, medians of 21 in turns: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in got.items()) + f" on {card}")
    return {"K1": (inf["K1"], k1_plain, inf["nn.LSTM inference"]),
            "K3a": (fwd["K3a"], k3a_plain, fwd["nn.LSTM training forward"]),
            "K3b": (bwd["K3b"], k3b_plain, bwd["nn.LSTM backward"])}


def rows_sweep(card):
    """Phase 9: where each step's time goes.  K1, K3a, K3b and K7 at T=720,
    H=768, bf16 (random inputs from the seed) for N in 16, 32, 64 (K1, K3a,
    K3b: the clustered launch of at most 64 rows) and 128 (K1 and K7 also
    192 and 256: one launch of the rows kernel, of one or two 128-row
    tiles; two clustered launches for K3b), each the median of 5 calls.
    The time per step and launch, fitted as a + b x rows over N <= 64 and,
    for K1 and K7, over 128-256 rows, splits a fixed cost per step from
    the cost of the rows."""
    from xna_basecaller_tpu_torch.ops import lstm, lstm_cuda

    T, H = 720, 768
    g = torch.Generator("cuda").manual_seed(SEED)
    w = (torch.randn(H, 4 * H, device="cuda", generator=g)
         / H ** 0.5).to(torch.bfloat16)
    w_q, scale = lstm.quantize_w_hh(w)
    for name, wrapper, sizes in (
            ("K1", lstm_cuda.lstm_recurrence, (16, 32, 64, 128, 192, 256)),
            ("K3a", lstm_cuda.lstm_forward_with_cells, (16, 32, 64, 128)),
            ("K3b", lstm_cuda.lstm_backward_dxp, (16, 32, 64, 128)),
            ("K7", lstm_cuda.lstm_recurrence_int8,
             (16, 32, 64, 128, 192, 256))):
        points = []
        for N in sizes:
            xp = torch.randn(T, N, 4 * H, device="cuda", generator=g).to(
                torch.bfloat16)
            with torch.no_grad():
                if name == "K3b":
                    ys, cs = lstm_cuda.lstm_forward_with_cells(xp, w)
                    dys = (torch.randn(T, N, H, device="cuda", generator=g)
                           * 1e-2).to(torch.bfloat16)
                    fn = lambda: wrapper(dys, xp, w, ys, cs)  # noqa: E731
                elif name == "K7":
                    fn = lambda: wrapper(xp, w_q, scale)  # noqa: E731
                else:
                    fn = lambda: wrapper(xp, w)  # noqa: E731
                before = wrapper.launches
                fn()
                launches = wrapper.launches - before
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
        print(f"rows sweep {name} (T={T}, H={H}, bf16): " + "; ".join(
            f"N={n}: {ms:.3f} ms, {launches} launch(es) of {rows} rows, "
            f"{us:.2f} us per step" for n, rows, launches, ms, us in points)
            + "; " + "; ".join(fits) + f" on {card}")


def crf_scan_turns(scores, train_scores, lattice, nb, sl, card, baseline):
    """Phase 9 (the CRF scans): K2a at the basecall batch, K5a (K2a's
    kernel) and K4 at the training batch, then the lattice's K6a at the
    training batch and at the validation batch's 16 rows and K6b at the
    training batch, on stay and move packed as the loss packs them, each
    the median of 21 samples of SCAN_BURST calls back to back (the
    wrapper's host time would show in a call timed alone: these kernels
    take well under a millisecond); with ``--baseline``, taken in turns
    with the baseline tree's kernel (on the lattice as that tree lays it
    out) after checking that betas, alphas, logZ, d_stay and d_move are
    bit-equal to its; and each plain version once.  Returns {kernel: (ms,
    plain ms)} at the training batch."""
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


def time_training(model, batch, loss_keep, card):
    """Phase 9 (training side): the loss kernel K5b (as ``crf_ms``) with
    its plain version (no PyTorch call computes this function), and one
    training step with its breakdown."""
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


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--baseline", default=None, metavar="DIR",
        help="another tree of this repository (e.g. the parent commit, "
             "unpacked by git archive) whose K1, K7, K2a, K4, K6a and K6b "
             "are timed in turns with this tree's (the CRF scans also held "
             "bit-equal)")
    args = parser.parse_args()
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
    baseline = baseline_kernels(args.baseline) if args.baseline else None
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
            results[f"K1_{name}_err"] = err.max().item()
            if name == "bf16":
                k1_inputs = (xp, p["w_hh"])
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
                "K7": lstm_cuda.lstm_recurrence_int8}
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

    # -- 4b. the quantized path, through run_basecaller(quantize=True) --
    for w in wrappers.values():
        w.launches = 0
    fastq_q = io.StringIO()
    stats_q = run_basecaller(model, iter(reads), fastq_q, chunksize=chunksize,
                             overlap=overlap, batchsize=batchsize,
                             quantize=True)
    q_launches = {k: w.launches for k, w in wrappers.items()}
    print(f"quantized path: {stats_q} launches {q_launches} "
          f"(batches {n_batches})")
    need = {"K7": enc.num_rnn_layers * n_batches, "K1": 0,
            "K2a": n_batches, "K2b": n_batches, "K2c": n_batches}
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
        timings = lstm_yardsticks(model, k3_inputs, k1_inputs, xb, card,
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

        scan_t = crf_scan_turns(scores, loss_inputs[0], loss_inputs[5:],
                                nb, sl, card, baseline)
        for k, v in scan_t.items():
            timings[k] = (*v, None)
        timings["K2b"] = (
            crf_ms(lambda: crf_cuda.forward_viterbi(
                scores, betas, logz, nb, sl)),
            elapsed_ms(lambda: crf.forward_viterbi(
                scores, betas, logz, nb, sl), 1), None)
        timings["K2c"] = (
            crf_ms(lambda: crf_cuda.viterbi_traceback(
                bp, v_final, nb, sl)),
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
    for k, v in timings.items():
        print(f"time {k}: {v} ms on {card}")
    t_train = time_training(model, tbatch, loss_inputs, card)
    timings["K5b"] = (*t_train["K5b"], None)
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
    }
    launches.update({k: train_launches[k] for k in (
        "K3a", "K3b", "K4", "K5b", "K6a", "K6b")})
    launches["K5a"] = train_launches["K2a"]
    launches["K7"] = q_launches["K7"]
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
