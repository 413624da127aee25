"""Time K1 (``csrc/lstm_recurrence.cu``) on one NVIDIA GPU against
another tree's K1 and against variants of either tree's design, in turns,
and hold each to bit-repeatability.

bf16 (the default), at the basecall batches of ``--rows`` (default 256,
ONT's and the port's, and 384, the XNA model's: xp [720, N, 3072], H=768),
both directions, random inputs from a seed:

  1. print the card's name and power limit; build this tree's K1, the
     variants of this tree's source in ``VARIANTS`` and, with
     ``--baseline DIR`` (another tree of this repository, e.g. the parent
     commit unpacked by ``git archive``; may be given more than once),
     DIR's K1, each with nvcc (a variant is a list of text edits of the
     source); each tree's K1 is called as its wrapper calls it, once per
     group of the rows a launch of that tree takes (256 before the wide
     geometry: 256 + 128 at N=384), and this tree's geometry is printed;
  2. call each kernel 6 times on the same inputs and print the share of ys
     elements that differ from the first call (0 means bit-repeatable);
     fail if this tree's kernel is not bit-repeatable; print each one's
     largest difference from this tree's ys;
  3. time them in turns (a, b, c, c, b, a, ...): the median of 21 calls
     each, by CUDA events, in each direction, beside the bound of the
     layer's recurrence (2 T N H 4H operations over 989 TFLOP/s).

``--dtype f32`` (K1's f32 route, which duplex's transition posteriors
run): for each N of ``--rows`` (default 8, 16, 32, 64, 128, 256) at T=720,
H=768, in both directions, this tree's K1, the variants of its source in
``F32_VARIANTS`` and, with ``--baseline DIR``, DIR's, each called 6 times (this tree's must be bit-repeatable) and held
to the plain version (``ops/lstm.py::lstm_recurrence``, max-abs 1e-4),
then timed in turns with this tree's input projection + K1 and cuDNN's
``torch.nn.LSTM(768, 768)`` in f32 on the same layer's weights (the
projection included; TF32 off for cuDNN and for matrix products, and
stated), medians of 21; and the bound of the layer's recurrence at that
N: 2 T N H 4H operations over the card's f32 peak outside the tensor
cores (67 TFLOP/s), or its bytes (xp, W_hh read once, ys written once)
over 3.35 TB/s, whichever is larger.

Run from the repository root:
    python -m xna_basecaller_tpu_torch.tools.k1_turns [--baseline DIR]
        [--rows 256,384] [--dtype f32 [--rows 8,16,...]]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time

import torch

from xna_basecaller_tpu_torch.ops import _build

T, H, SEED, REPEATS, REPS = 720, 768, 0, 6, 21
BF16_ROWS = (256, 384)
F32_ROWS = (8, 16, 32, 64, 128, 256)
F32_TOL = 1e-4               # max-abs against the plain version
# H100 SXM: bf16 and f32 FLOP/s, HBM bytes/s
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12

# name -> edits of this tree's source, timed with bf16
VARIANTS = {
    # 64-column chunks: the wide geometry on 5 stages, fetched as their
    # writers finish within a window of 4 (the narrow one on 8, window 7)
    "64-column chunks": [("constexpr int kMaxSubs = 4;",
                          "constexpr int kMaxSubs = 1;")],
}
# name -> edits of this tree's source, timed with --dtype f32: the f32
# route with a lane's product over 1 or 2 batch rows at once (this tree's:
# 4), and with each part switched off in turn (wrong results: timing only)
_ROWS = "constexpr int kFRows = 4;"
F32_VARIANTS = {
    "1 row at once": [(_ROWS, _ROWS.replace("4", "1"))],
    "2 rows at once": [(_ROWS, _ROWS.replace("4", "2"))],
    "no product": [("for (int r = 0; r < rows; r += kFRows) {",
                    "for (int r = 0; r < 0; r += kFRows) {")],
    "no staging": [("for (int idx = lane; idx < rows * KW / 4; idx += 32) {",
                    "for (int idx = lane; idx < 0; idx += 32) {")],
    "no flag wait": [("    while (seen < target) {",
                      "    while (seen < target && false) {")],
    "no cell update": [("    if (mine) {\n      float g[4];",
                        "    if (false) {\n      float g[4];")],
}


def build_all(builds: dict) -> dict:
    """{name: (src, edits)} -> {name: CDLL}: each ``src`` (a
    lstm_recurrence.cu), with the text ``edits`` made in a copy in this
    tree's build directory, built with nvcc (the source's own directory on
    the include path), all started together."""
    os.makedirs(_build.BUILD, exist_ok=True)
    procs = {}
    for i, (name, (src, edits)) in enumerate(builds.items()):
        include = f"-I{os.path.dirname(os.path.abspath(src))}"
        if edits:
            text = open(src).read()
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"k1_turns: {name}: the edited text is "
                                     f"not once in {src}: {old[:60]!r}")
                text = text.replace(old, new)
            src = os.path.join(_build.BUILD, f"k1_turns_k{i}.cu")
            with open(src, "w") as f:
                f.write(text)
        out = os.path.join(_build.BUILD, f"k1_turns_k{i}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, include, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        text, _ = proc.communicate()
        print(f"== nvcc {name} (rc={proc.returncode})\n{text}")
        if proc.returncode:
            raise SystemExit(f"k1_turns: {name} does not build")
        libs[name] = ctypes.CDLL(out)
    return libs


def kernel(lib: ctypes.CDLL, tag: str):
    """fn(xp, w_hh, reverse) -> ys through ``lib``'s ``xna_lstm_recurrence``,
    in xp's dtype (bf16 or f32): one launch per group of the rows a launch
    of ``lib`` takes.  A tree without ``xna_lstm_bf16_geometry`` takes 256
    rows in either dtype, its ``xna_lstm_group_rows`` no argument and its
    ``xna_lstm_recurrence`` no pointer for the geometry it took."""
    def typed(name, drop=0):
        """``name`` typed from this tree's table, less its last ``drop``
        arguments (an older tree's), or None where ``lib`` lacks it."""
        if not hasattr(lib, name):
            return None
        if not drop:
            return _build.entry(name, lib)
        fn = getattr(lib, name)
        fn.argtypes = _build.ENTRY_POINTS[name].argtypes[:-drop]
        fn.restype = ctypes.c_int
        return fn

    bf16_geo = typed("xna_lstm_bf16_geometry")
    old = bf16_geo is None
    fn = typed("xna_lstm_recurrence", drop=int(old))
    wide = () if old else (None,)
    elems = typed("xna_lstm_hbuf_elems")
    group_rows = typed("xna_lstm_group_rows", drop=int(old))

    def run(xp, w_hh, reverse):
        t, n, h4 = xp.shape
        h = h4 // 4
        bf16 = xp.dtype == torch.bfloat16
        group = group_rows(int(bf16)) if bf16_geo is not None \
            else group_rows()
        ys = torch.empty(t, n, h, dtype=xp.dtype, device=xp.device)
        size = xp.element_size()
        for n0 in range(0, n, group):
            rows = min(group, n - n0)
            hbuf = torch.zeros(elems(rows, h), dtype=xp.dtype,
                               device=xp.device)
            flags = torch.zeros(h, dtype=torch.int32, device=xp.device)
            rc = fn(xp.data_ptr() + n0 * h4 * size, w_hh.data_ptr(),
                    ys.data_ptr() + n0 * h * size, None, hbuf.data_ptr(),
                    flags.data_ptr(), t, rows, n, h, int(reverse), int(bf16),
                    torch.cuda.current_stream().cuda_stream, *wide)
            if rc:
                raise SystemExit(f"k1_turns: {tag}'s kernel returned {rc}")
        return ys

    def bf16_geometry(n, h):
        """This tree's bf16 geometry of a launch of n rows, where the
        library tells."""
        if bf16_geo is None:
            return "not exported"
        out = (ctypes.c_int * 5)()
        rc = bf16_geo(n, h, out)
        return dict(zip(("wide", "rows a tile", "CTAs", "columns a chunk",
                         "ring stages"), out)) \
            if rc == 0 else rc
    run.bf16_geometry = bf16_geometry

    geo = typed("xna_lstm_f32_geometry")

    def geometry(n, h):
        """The f32 route's (units, depth, rows a block, staging buffers)
        for n rows of width h, where the library tells."""
        if geo is None:
            return "not exported"
        out = (ctypes.c_int * 4)()
        rc = geo(n, h, out)
        return dict(zip(("units", "depth", "rows a block",
                         "staging buffers"), out)) if rc == 0 else rc
    run.geometry = geometry
    return run


def wait(what: str, seconds: float = 60.0):
    """Wait for the work enqueued on the current stream, polling; exit the
    process (which ends its kernels) if it takes longer than ``seconds``:
    a kernel that deadlocks fails the run instead of holding the card."""
    ev = torch.cuda.Event()
    ev.record()
    deadline = time.monotonic() + seconds
    while not ev.query():
        if time.monotonic() > deadline:
            print(f"k1_turns: {what} did not finish in {seconds:.0f} s",
                  flush=True)
            os._exit(3)
        time.sleep(0.001)


def in_turns(fns: dict, reps: int = REPS) -> dict:
    """Median device time (ms) of each function over ``reps`` calls, taken
    in turns whose order reverses every round, after one warm-up each."""
    names = list(fns)
    for n in names:
        fns[n]()
        wait(n)
    times = {n: [] for n in names}
    for r in range(reps):
        for n in names if r % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[n]()
            end.record()
            wait(n)
            times[n].append(start.elapsed_time(end))
    return {n: statistics.median(v) for n, v in times.items()}


def repeatable(fn, xp, w_hh, reverse, name) -> tuple:
    """Call ``fn`` REPEATS times; -> (its first ys, the largest share of
    ys elements that differed from the first call in any later one)."""
    first = fn(xp, w_hh, reverse)
    wait(name)
    worst = 0.0
    for _ in range(REPEATS - 1):
        again = fn(xp, w_hh, reverse)
        wait(name)
        worst = max(worst, (again != first).float().mean().item())
    return first, worst


def f32_turns(kernels: dict, rows, card: str) -> None:
    """``--dtype f32``: the rows sweep of K1's f32 route beside the port's
    projection + K1, cuDNN's f32 LSTM and the bound (module docstring)."""
    from xna_basecaller_tpu_torch.ops import lstm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"f32: torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    this = kernels["this tree"]
    gen = torch.Generator().manual_seed(SEED)
    w_ih = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) / H ** 0.5).cuda()
    w_hh = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) / H ** 0.5).cuda()
    bias = (torch.randn(4 * H, generator=gen) * 0.5).cuda()
    summary = []
    for n in rows:
        for name, fn in kernels.items():
            print(f"K1 f32 N={n}, {name}: geometry {fn.geometry(n, H)}")
        x = torch.randn(T, n, H, generator=gen).cuda()
        xp = torch.addmm(bias, x.reshape(T * n, H), w_ih).reshape(T, n, -1)
        for reverse in (False, True):
            ref = torch.nn.LSTM(H, H).cuda().eval()
            with torch.no_grad():
                ref.weight_ih_l0.copy_(w_ih.T)
                ref.weight_hh_l0.copy_(w_hh.T)
                ref.bias_ih_l0.copy_(bias)
                ref.bias_hh_l0.zero_()
            ref.flatten_parameters()
            x_in = x.flip(0) if reverse else x
            with torch.inference_mode():
                plain = lstm.lstm_recurrence(xp, w_hh, reverse)
                for name, fn in kernels.items():
                    got, worst = repeatable(fn, xp, w_hh, reverse, name)
                    err = (got - plain).abs().max().item()
                    print(f"K1 f32 [{T}, {n}, {4 * H}] reverse={reverse}, "
                          f"{name}: {REPEATS} calls, at most "
                          f"{100 * worst:.3f} % of ys differ from the first;"
                          f" max_abs against the plain version {err:.3e} "
                          f"(tolerance {F32_TOL})")
                    if name == "this tree" and (worst or err > F32_TOL):
                        raise SystemExit("k1_turns: this tree's f32 K1 is "
                                         "not bit-repeatable or disagrees "
                                         "with its plain version")
                cud = ref(x_in)[0]
                cud = cud.flip(0) if reverse else cud
                print(f"nn.LSTM f32 against the plain version: max_abs "
                      f"{(cud - plain).abs().max().item():.3e}")
                fns = {f"K1, {k}": (lambda fn=fn: fn(xp, w_hh, reverse))
                       for k, fn in kernels.items()}
                fns["projection + K1, this tree"] = lambda: this(
                    torch.addmm(bias, x.reshape(T * n, H), w_ih).reshape(
                        T, n, -1), w_hh, reverse)
                fns["nn.LSTM f32 (cuDNN, projection included)"] = \
                    lambda: ref(x_in)
                times = in_turns(fns)
            t_ops = 2.0 * T * n * H * 4 * H / PEAK_F32
            t_bytes = 4.0 * (xp.numel() + w_hh.numel() + T * n * H) \
                / PEAK_BYTES
            bound_ms = max(t_ops, t_bytes) * 1e3
            by = "operations" if t_ops >= t_bytes else "bytes"
            for name, ms in times.items():
                print(f"K1 f32 [{T}, {n}, {4 * H}] reverse={reverse}, "
                      f"{name}: median {ms:.3f} ms of {REPS} in turns "
                      f"({card})")
            print(f"K1 f32 [{T}, {n}, {4 * H}] bound {bound_ms:.4f} ms "
                  f"({by})")
            summary.append((n, reverse, times, bound_ms))
            del ref
        del x, xp
    print(f"summary, K1 f32 at T={T}, H={H}, medians of {REPS} in turns "
          f"(ms; {card}):")
    for n, reverse, times, bound_ms in summary:
        print(f"  N={n} reverse={reverse}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items())
            + f", bound {bound_ms:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="DIR", help="another tree (may be repeated)")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--rows", default=None,
                    help="the batch rows N timed, comma-separated (default "
                         f"{','.join(map(str, BF16_ROWS))} in bf16, "
                         f"{','.join(map(str, F32_ROWS))} in f32; f32 at "
                         "most 256)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_turns: no CUDA device")
    f32 = args.dtype == "f32"
    rows = [int(v) for v in args.rows.split(",")] if args.rows else list(
        F32_ROWS if f32 else BF16_ROWS)
    if f32 and not all(1 <= n <= 256 for n in rows):
        raise SystemExit("k1_turns: --rows takes 1 to 256 rows")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)

    this_src = os.path.join(_build.CSRC, "lstm_recurrence.cu")
    builds = {"this tree": (this_src, ())}
    builds.update({f"this tree, {n}": (this_src, e) for n, e in (
        F32_VARIANTS if f32 else VARIANTS).items()})
    for root in args.baseline:
        tag = "baseline" if len(args.baseline) == 1 else f"baseline {root}"
        builds[tag] = (os.path.join(root, "xna_basecaller_tpu_torch", "csrc",
                                    "lstm_recurrence.cu"), ())
    kernels = {name: kernel(lib, name)
               for name, lib in build_all(builds).items()}
    if f32:
        f32_turns(kernels, rows, card)
        torch.cuda.synchronize()
        return 0

    gen = torch.Generator().manual_seed(SEED)
    w_hh = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) / H ** 0.5).to(
        "cuda", torch.bfloat16)
    summary = []
    for n in rows:
        for name, fn in kernels.items():
            print(f"K1 N={n}, {name}: geometry {fn.bf16_geometry(n, H)}")
        xp = (torch.randn(T, n, 4 * H, generator=gen) * 0.5).to(
            "cuda", torch.bfloat16)
        bound_ms = 2.0 * T * n * H * 4 * H / PEAK_BF16 * 1e3
        for reverse in (False, True):
            ys = {}
            for name, fn in kernels.items():
                ys[name], worst = repeatable(fn, xp, w_hh, reverse, name)
                diff = (ys[name].float() - ys["this tree"].float()).abs()
                print(f"K1 [{T}, {n}, {4 * H}] reverse={reverse}, {name}: "
                      f"{REPEATS} calls, at most {100 * worst:.3f} % of ys "
                      f"differ from the first call; max_abs against this "
                      f"tree's {diff.max().item():.3e}")
                if name == "this tree" and worst:
                    raise SystemExit("k1_turns: this tree's K1 is not "
                                     "bit-repeatable")
            del ys
            times = in_turns({k: (lambda fn=fn: fn(xp, w_hh, reverse))
                              for k, fn in kernels.items()})
            for name, ms in times.items():
                print(f"K1 [{T}, {n}, {4 * H}] reverse={reverse}, {name}: "
                      f"median {ms:.3f} ms of {REPS} in turns ({card})")
            summary.append((n, reverse, times, bound_ms))
        del xp
    print(f"summary, K1 bf16 at T={T}, H={H}, medians of {REPS} in turns "
          f"(ms; {card}):")
    for n, reverse, times, bound_ms in summary:
        print(f"  N={n} reverse={reverse}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items())
            + f", bound {bound_ms:.4f}")
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
