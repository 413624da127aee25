#!/usr/bin/env python3
"""Time the stay/move lattice kernels K6a and K6b of
``xna_basecaller_tpu_torch/csrc/crf_loss.cu`` on one NVIDIA GPU against
variants of their design, and the CTC-CRF loss through them against
another tree's lattice kernels, in turns (a, b, b, a, ...; medians of 21
samples) at the flagship training shapes (T=720, N=64 and the validation
batch's 16 rows, n=448 lattice positions).

  1. print the card's name and power limit; write each variant of
     ``crf_loss.cu`` (an edit of this tree's source) under the build
     directory and build it with nvcc beside this tree's kernels;
  2. hold each variant's alphas, logZ, d_stay and d_move bit-equal to this
     tree's kernels', then time K6a and K6b against them in turns (samples
     of 10 calls back to back, as ``chip_smoke.py`` times the CRF scans);
  3. with ``--baseline DIR`` (another tree, e.g. the parent commit unpacked
     by ``git archive``): the loss forward + backward (``ctc_loss`` of
     random scores and simulated targets, with its gradient) through this
     tree's lattice Function and through one that runs DIR's K6a and K6b
     on contiguous stay and move, in turns (single calls, CUDA events, so
     that the host's enqueue shows where it holds the card back), the
     losses held bit-equal; and each one's device time over its wall time
     for 5 calls, by ``torch.profiler``.

Run from the repository root:  python3 lattice_turns.py [--baseline DIR]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

SRC = os.path.join("xna_basecaller_tpu_torch", "csrc")
SEED = 0

# name -> [(text of this tree's crf_loss.cu, its replacement)]; the first,
# unedited, is called as the others are (not through the wrapper, whose
# host time shows in the first call of each sample)
VARIANTS = {
    "this tree's source, called as the variants": [],
    "no extra warp (a working thread issues the copies)": [(
        "return std::min((n + 31) / 32 * 32 + 32, kLatThreads);",
        "return std::min((n + 31) / 32 * 32, kLatThreads);")],
    "4 stages": [("for (int D = kRingStages; D > 2; D /= 2)",
                  "for (int D = 4; D > 2; D /= 2)")],
    "2 stages": [("for (int D = kRingStages; D > 2; D /= 2)",
                  "for (int D = 2; D > 2; D /= 2)")],
    "K6b's posteriors after its beta": [(
        """      ds[j] = expf(((av[j] + st[j]) + bj) - lz) * c;
      const float stay_term = st[j] + bj;
      float out = stay_term;
      if (j < n - 1) {
        const float bj1 = beta[j + 1];
        dm[j] = expf(((av[j] + mv[j]) + bj1) - lz) * c;
        const float move_term = mv[j] + bj1;
        out = fmaxf(stay_term, move_term) +
              log1pf(expf(-fabsf(stay_term - move_term)));
      }
      beta_next[j] = out;""",
        """      const float stay_term = st[j] + bj;
      float out = stay_term, bj1 = 0.0f;
      if (j < n - 1) {
        bj1 = beta[j + 1];
        const float move_term = mv[j] + bj1;
        out = fmaxf(stay_term, move_term) +
              log1pf(expf(-fabsf(stay_term - move_term)));
      }
      beta_next[j] = out;
      ds[j] = expf(((av[j] + st[j]) + bj) - lz) * c;
      if (j < n - 1) dm[j] = expf(((av[j] + mv[j]) + bj1) - lz) * c;""")],
}


def build_variants() -> dict:
    """Each variant's lattice kernels, as ``cs.lattice_kernels``."""
    from xna_basecaller_tpu_torch.ops import _build

    with open(os.path.join(SRC, "crf_loss.cu")) as fh:
        base = fh.read()
    out = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        root = os.path.join(_build.BUILD, "lattice_variants", str(i))
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(SRC, os.path.join(root, SRC))
        text = base
        for old, new in edits:
            if old not in text:
                cs.fail(f"variant {name!r}: its edit no longer applies")
            text = text.replace(old, new)
        with open(os.path.join(root, SRC, "crf_loss.cu"), "w") as fh:
            fh.write(text)
        out[name] = cs.lattice_kernels(
            cs.build_tree(root, ("crf_loss",), f"variant{i}")["crf_loss"],
            f"variant {name!r}")
    return out


def lattice_inputs(T=720, N=64, n=448):
    """stay, move (the loss's packed views), int32 lengths and ct on the
    card, from a seed: log-probabilities of the size the loss gives."""
    from xna_basecaller_tpu_torch.ops import crf_cuda

    g = torch.Generator().manual_seed(SEED)
    stay = torch.randn(T, N, n, generator=g) - 2
    move = torch.randn(T, N, n - 1, generator=g) - 2
    lengths = torch.randint(n - 100, n + 1, (N,), generator=g)
    ct = torch.randn(N, generator=g) / N
    s, m = crf_cuda.lattice_unpack(
        crf_cuda.lattice_pack(stay.cuda(), move.cuda()), n)
    return s, m, lengths.to(torch.int32).cuda(), ct.cuda()


def kernel_turns(kernels: dict, card: str):
    """Phase 2: K6a at 64 and 16 rows and K6b at 64 against each variant."""
    from xna_basecaller_tpu_torch.ops import crf_cuda

    stay, move, lengths, ct = lattice_inputs()
    T, N, n = stay.shape
    for k, rows in (("K6a", N), ("K6a", 16), ("K6b", N)):
        s, m = crf_cuda.lattice_unpack(crf_cuda.lattice_pack(
            stay[:, :rows], move[:, :rows]), n)
        ln, c = lengths[:rows], ct[:rows]
        alphas, logz = crf_cuda.lattice_forward(s, m, ln)
        d_stay, d_move = crf_cuda.lattice_backward(s, m, ln, alphas, logz, c)
        fns = {"this tree (wrapper)": (
            (lambda: crf_cuda.lattice_forward(s, m, ln)) if k == "K6a" else
            (lambda: crf_cuda.lattice_backward(s, m, ln, alphas, logz, c)))}
        for name, lat in kernels.items():
            ins = lat["inputs"](s, m)
            a_v, z_v = lat["K6a"](ins, ln)
            got = (a_v, z_v, *lat["K6b"](ins, ln, a_v, z_v, c))
            want = (alphas, logz, d_stay, d_move)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                cs.fail(f"variant {name!r} is not bit-equal to this tree")
            fns[name] = ((lambda lat=lat, ins=ins: lat["K6a"](ins, ln))
                         if k == "K6a" else
                         (lambda lat=lat, ins=ins, a_v=a_v: lat["K6b"](
                             ins, ln, a_v, logz, c)))
        t = cs.in_turns(fns, burst=cs.SCAN_BURST)
        print(f"time {k} (T={T}, N={rows}, n={n}), medians of 21 samples of "
              f"{cs.SCAN_BURST} calls in turns, all bit-equal: " + ", ".join(
                  f"{name} {v:.4f} ms ({v / T * 1e3:.3f} us a step)"
                  for name, v in t.items()) + f" on {card}")


def loss_turns(baseline: dict, card: str):
    """Phase 3: the loss forward + backward through this tree's lattice
    Function and through one that runs the baseline tree's kernels."""
    from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset
    from xna_basecaller_tpu_torch.ops import crf

    ours = crf._CTCLatticeLogZ

    class TheirLattice(torch.autograd.Function):
        """The lattice's logZ through the baseline tree's K6a and K6b, on
        stay and move as that tree lays them out."""

        @staticmethod
        def forward(ctx, stay, move, lengths):
            lengths = lengths.to(torch.int32)
            ctx.lattice = baseline["inputs"](stay, move)
            alphas, lz = baseline["K6a"](ctx.lattice, lengths)
            ctx.save_for_backward(lengths, alphas, lz)
            return lz

        @staticmethod
        def backward(ctx, ct):
            d_stay, d_move = baseline["K6b"](ctx.lattice, *ctx.saved_tensors,
                                             ct.contiguous())
            return d_stay, d_move, None

    nb, sl, C = 6, 3, 7 * 216
    rng = np.random.default_rng(SEED)
    scores = torch.from_numpy((np.tanh(rng.standard_normal(
        (720, 64, C))) * 5).astype(np.float32)).cuda().requires_grad_()
    _, targets, lengths, _ = simulate_ctc_dataset(
        64, chunk_len=3600, target_len=400, seed=SEED)
    targets = torch.from_numpy(targets.astype(np.int64)).cuda()
    lengths = torch.from_numpy(lengths.astype(np.int64)).cuda()

    def loss_fwd_bwd(function):
        def run():
            crf._CTCLatticeLogZ = function
            try:
                scores.grad = None
                loss = crf.ctc_loss(scores, targets, lengths, nb, sl)
                loss.backward()
                return loss.detach()
            finally:
                crf._CTCLatticeLogZ = ours
        return run

    fns = {"this tree": loss_fwd_bwd(ours),
           "baseline lattice": loss_fwd_bwd(TheirLattice)}
    got = {k: f() for k, f in fns.items()}
    grads = {}
    for k, f in fns.items():
        f()
        grads[k] = scores.grad.clone()
    same = torch.equal(*got.values())
    grad_rel = cs.rel_err(*grads.values())
    print(f"loss through this tree's lattice vs the baseline's: "
          f"{'bit-equal' if same else 'DIFFERENT'} ({got['this tree']:.6f});"
          f" gradient max |a-b| / max |b| {grad_rel:.3e} (the gather's "
          "backward adds in an order that varies from run to run)")
    if not same:
        cs.fail("the loss through this tree's lattice differs")
    t = cs.in_turns(fns)
    print(f"time loss forward + backward (T=720, N=64, n at most "
          f"{targets.shape[1] - sl + 1}), medians of 21 single calls in "
          "turns: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in t.items()) + f" on {card}")
    from torch.profiler import ProfilerActivity, profile

    for k, f in fns.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                f()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        device = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"profile loss forward + backward, {k}: 5 calls {wall:.3f} ms "
              f"wall (profiler on), kernels {device / 1e3:.3f} ms, device "
              f"busy {device / 1e3 / wall:.3f} of the wall time on {card}")


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", default=None, metavar="DIR",
                        help="another tree whose lattice kernels the loss "
                             "is timed with, in turns with this tree's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("lattice_turns: no CUDA device", file=sys.stderr)
        return 1
    from xna_basecaller_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    _build.build(["crf_loss"])
    kernel_turns(build_variants(), card)
    if args.baseline:
        libs = cs.build_tree(args.baseline, ("crf_loss",), "baseline")
        loss_turns(cs.lattice_kernels(libs["crf_loss"], "the baseline tree"),
                   card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
