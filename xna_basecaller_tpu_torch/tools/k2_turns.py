"""Time the Viterbi decode's kernels K2a, K2b and K2c (``csrc/crf_decode.cu``)
on one NVIDIA GPU on their wide path, against variants of its block shape,
in turns; and hold the kernels of other shapes to another tree's, bit for
bit.

At NACGT, state_len 5 (1024 states x 5 columns, the R10.4.1 sup model's
CRF), T=2000 frames (a chunk of 10,000 samples at stride 5) and the
batches of ``--rows`` (default 16 and 256), random scores tanh(randn) x 5
made on the card from a seed:

  1. print the card's name and power limit; build this tree's
     ``crf_decode.cu`` and the variants of it in ``VARIANTS`` (each a list
     of text edits of the source), each with nvcc, the ``-Xptxas -v``
     lines of the wide kernels printed;
  2. run each one's chain (K2a, logZ as one torch reduction, K2b, K2c) and
     hold it to this tree's: betas, backpointers and labels bit-equal
     (every variant does the same arithmetic a state); hold this tree's
     to the plain decode (``ops/crf.py``) at the smallest batch: betas
     within rtol 1e-5, labels equal but for f32 near-ties (at most 1e-3 of
     them);
  3. time each kernel, and the chain, in turns (a, b, c, c, b, a, ...):
     the median of 21 calls each, by CUDA events, beside the bound of the
     chain's bytes (``portbench/crf_work.py``'s arithmetic: K2a reads the
     scores and writes the betas, K2b reads both and writes the uint8
     backpointers, K2c its walk's) over 3.35 TB/s; the plain decode once.

With ``--baseline DIR`` (another tree of this repository, e.g. the parent
commit unpacked by ``git archive``), DIR's ``crf_decode.cu`` is built too,
and at the shapes both trees take on their first path (NACGTXY at
state_len 3: 216 states x 7; NACGT at 4: 256 x 5; T=300, N=32, scores of
integer thousandths drawn on the host, so that every machine makes the
same inputs) the two trees' betas, v_final, backpointers and labels are
compared bit for bit, and the sha256 of this tree's are printed (the
digests ``tests/test_torch_kernels_gpu.py`` holds the kernels to).

Run from the repository root:
    python -m xna_basecaller_tpu_torch.tools.k2_turns [--baseline DIR]
        [--rows 16,256]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

from xna_basecaller_tpu_torch.ops import _build, crf
from xna_basecaller_tpu_torch.tools.k1_turns import in_turns, wait

T, NB, SL, SEED, REPS = 2000, 4, 5, 0, 21
ROWS = (16, 256)
PEAK_BYTES = 3.35e12
# the first path's shapes held to the baseline: (n_base, state_len)
FIRST_PATH = ((6, 3), (4, 4))
FIRST_T, FIRST_N = 300, 32

# name -> edits of this tree's source: the wide path's ScanShape<threads,
# states a thread, ring stages, blocks an SM>
_WIDE = "using WideShape = ScanShape<512, 2, 4, 2>;"
VARIANTS = {
    "1024 threads, 1 state a thread": [
        (_WIDE, _WIDE.replace("512, 2,", "1024, 1,"))],
    "256 threads, 4 states a thread": [
        (_WIDE, _WIDE.replace("512, 2,", "256, 4,"))],
    "1024 threads on 8 stages, one block an SM": [
        (_WIDE, _WIDE.replace("512, 2, 4, 2", "1024, 1, 8, 1"))],
}
# the first path's shape, ScanShape<256, 1, 8, 1>, in a mangled kernel name
_FIRST_MANGLED = "ScanShapeILi256ELi1ELi8ELi1E"


def build_all(builds: dict) -> dict:
    """{name: (src, edits)} -> {name: CDLL}: each ``src`` (a crf_decode.cu)
    with its text ``edits`` made in a copy in this tree's build directory,
    built with nvcc (the source's own directory on the include path), all
    started together."""
    os.makedirs(_build.BUILD, exist_ok=True)
    procs = {}
    for i, (name, (src, edits)) in enumerate(builds.items()):
        include = f"-I{os.path.dirname(os.path.abspath(src))}"
        if edits:
            text = open(src).read()
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"k2_turns: {name}: the edited text is "
                                     f"not once in {src}: {old[:60]!r}")
                text = text.replace(old, new)
            src = os.path.join(_build.BUILD, f"k2_turns_k{i}.cu")
            with open(src, "w") as f:
                f.write(text)
        out = os.path.join(_build.BUILD, f"k2_turns_k{i}.so")
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, include, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        text, _ = proc.communicate()
        print(f"== nvcc {name} (rc={proc.returncode}); the wide kernels:")
        print("\n".join(_ptxas_of_wide(text)) or "(none)")
        if proc.returncode:
            print(text)
            raise SystemExit(f"k2_turns: {name} does not build")
        libs[name] = ctypes.CDLL(out)
    return libs


def _ptxas_of_wide(text: str) -> list[str]:
    """The ``-Xptxas -v`` lines of the wide kernels: each ``Compiling
    entry`` line naming a scan on a shape other than the first path's,
    and the lines after it up to the next."""
    out, keep = [], False
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            keep = "ScanShape" in ln and _FIRST_MANGLED not in ln
        if keep:
            out.append(ln)
    return out


class Chain:
    """K2a, K2b and K2c through a library's C entry points.  A tree
    without the wide path takes no pointer for it: the trailing null is
    ignored there."""

    def __init__(self, lib: ctypes.CDLL, tag: str):
        self.tag = tag
        self.bwd = _build.entry("xna_crf_backward", lib)
        self.fwd = _build.entry("xna_crf_fwd_viterbi", lib)
        self.tb = _build.entry("xna_crf_traceback", lib)

    def _ok(self, rc, what):
        if rc:
            raise SystemExit(f"k2_turns: {self.tag}'s {what} returned {rc}")

    def k2a(self, s, nb, ns, betas):
        T_, N = s.shape[:2]
        self._ok(self.bwd(s.data_ptr(), betas.data_ptr(), T_, N, nb, ns,
                          torch.cuda.current_stream().cuda_stream, None),
                 "K2a")

    def k2b(self, s, betas, logz, nb, ns, bp, v):
        T_, N = s.shape[:2]
        self._ok(self.fwd(s.data_ptr(), betas.data_ptr(), logz.data_ptr(),
                          bp.data_ptr(), v.data_ptr(), T_, N, nb, ns,
                          torch.cuda.current_stream().cuda_stream, None),
                 "K2b")

    def k2c(self, bp, v, nb, labels):
        T_, N, ns = bp.shape
        self._ok(self.tb(bp.data_ptr(), v.data_ptr(), labels.data_ptr(), T_,
                         N, nb, ns, torch.cuda.current_stream().cuda_stream,
                         None), "K2c")

    def outputs(self, s, nb, sl):
        """(betas, v_final, bp, labels) of the chain on scores ``s``."""
        T_, N, _ = s.shape
        ns = nb ** sl
        betas = torch.empty(T_ + 1, N, ns, device=s.device)
        self.k2a(s, nb, ns, betas)
        logz = crf.logz_from_betas(betas)
        bp = torch.empty(T_, N, ns, dtype=torch.uint8, device=s.device)
        v = torch.empty(N, ns, device=s.device)
        self.k2b(s, betas, logz, nb, ns, bp, v)
        labels = torch.empty(N, T_, dtype=torch.int8, device=s.device)
        self.k2c(bp, v, nb, labels)
        wait(f"{self.tag}'s chain")
        return betas, v, bp, labels


def chain_bytes(T_: int, N: int, nb: int, ns: int) -> dict:
    """Bytes of each kernel's inputs read once and outputs written once
    (``portbench/crf_work.py``'s arithmetic): K2a the scores in, the betas
    out; K2b the scores, the betas it adds and logZ in, the uint8
    backpointers and v_final out; K2c v_final and a walk's backpointer a
    step in, the int8 labels out."""
    scores = 4.0 * T_ * N * ns * (nb + 1)
    v_final = 4.0 * N * ns
    return {"K2a": scores + 4.0 * (T_ + 1) * N * ns,
            "K2b": scores + 4.0 * T_ * N * ns + 4.0 * N + T_ * N * ns
            + v_final,
            "K2c": v_final + 2.0 * T_ * N}


def first_path_inputs(nb: int, sl: int) -> torch.Tensor:
    """Scores of integer thousandths in [-5, 5], drawn on the host from
    SEED: the same on every machine."""
    rng = np.random.default_rng(SEED)
    C = (nb + 1) * nb ** sl
    ints = rng.integers(-5000, 5001, size=(FIRST_T, FIRST_N, C))
    return torch.from_numpy(ints.astype(np.float32) * np.float32(1e-3))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default=None, metavar="DIR")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_turns: no CUDA device")
    rows = [int(v) for v in args.rows.split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    this_src = os.path.join(_build.CSRC, "crf_decode.cu")
    builds = {"this tree": (this_src, ())}
    builds.update({f"this tree, {n}": (this_src, e)
                   for n, e in VARIANTS.items()})
    if args.baseline:
        builds["baseline"] = (os.path.join(
            args.baseline, "xna_basecaller_tpu_torch", "csrc",
            "crf_decode.cu"), ())
    chains = {n: Chain(lib, n) for n, lib in build_all(builds).items()}

    if args.baseline:
        for nb, sl in FIRST_PATH:
            s = first_path_inputs(nb, sl).cuda()
            got = chains["this tree"].outputs(s, nb, sl)
            want = chains["baseline"].outputs(s, nb, sl)
            same = [torch.equal(a, b) for a, b in zip(got, want)]
            print(f"first path, {nb ** sl} states x {nb + 1}, T={FIRST_T}, "
                  f"N={FIRST_N}: betas, v_final, bp, labels bit-equal to "
                  f"the baseline's: {same}; sha256 of this tree's "
                  f"{digest(*got)}")
            if not all(same):
                raise SystemExit("k2_turns: the first path moved")

    ns = NB ** SL
    gen = torch.Generator("cuda").manual_seed(SEED)
    summary = []
    for n in rows:
        s = torch.tanh(torch.randn(T, n, ns * (NB + 1), device="cuda",
                                   generator=gen)) * 5
        ref = chains["this tree"].outputs(s, NB, SL)
        for name, ch in chains.items():
            if name == "baseline":
                continue
            got = ch.outputs(s, NB, SL)
            same = [torch.equal(a, b) for a, b in zip(got, ref)]
            print(f"N={n}, {name}: betas, v_final, bp, labels bit-equal to "
                  f"this tree's: {same}")
            if not all(same):
                raise SystemExit(f"k2_turns: {name} differs")
        if n == min(rows):
            betas = crf.backward_scores(s, NB, SL)
            torch.testing.assert_close(ref[0], betas, rtol=1e-5, atol=1e-5)
            labels = crf.decode_paths(s, NB, SL)
            share = (labels != ref[3]).float().mean().item()
            print(f"N={n}: betas within rtol 1e-5 of the plain scan's; "
                  f"{share:.2e} of labels differ from the plain decode's")
            if share > 1e-3:
                raise SystemExit("k2_turns: the decode is not the plain one")
        betas, v, bp, labels = ref
        logz = crf.logz_from_betas(betas)
        fns = {}
        for name, ch in chains.items():
            if name == "baseline":
                continue
            fns[f"K2a, {name}"] = (lambda ch=ch: ch.k2a(s, NB, ns, betas))
            fns[f"K2b, {name}"] = (lambda ch=ch: ch.k2b(s, betas, logz, NB,
                                                        ns, bp, v))
            fns[f"K2c, {name}"] = (lambda ch=ch: ch.k2c(bp, v, NB, labels))
            fns[f"chain, {name}"] = (lambda ch=ch: ch.outputs(s, NB, SL))
        times = in_turns(fns, REPS)
        nbytes = chain_bytes(T, n, NB, ns)
        bound = {k: b / PEAK_BYTES * 1e3 for k, b in nbytes.items()}
        bound["chain"] = sum(bound.values())
        for k, ms in times.items():
            part = k.split(",")[0]
            print(f"N={n} {k}: median {ms:.3f} ms of {REPS} in turns, bound "
                  f"{bound[part]:.4f} ms ({card})")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        crf.decode_paths(s, NB, SL)
        end.record()
        torch.cuda.synchronize()
        plain = start.elapsed_time(end)
        print(f"N={n}: the plain decode (ops/crf.py) on the card, once: "
              f"{plain:.1f} ms")
        summary.append((n, times, bound, plain))
        del s, ref, betas, v, bp, labels
    print(f"summary, K2 at {ns} states x {NB + 1}, T={T}, medians of {REPS} "
          f"in turns (ms; {card}):")
    for n, times, bound, plain in summary:
        print(f"  N={n}: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in times.items())
              + f"; bounds {bound}; plain {plain:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
