"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exports plain C functions (no PyTorch headers), so
one ``nvcc`` call per source takes seconds.  Sources are compiled at first
use, never at import, for ``sm_90a`` (Hopper), all in parallel, into
``build/`` beside this package's sources; a library's file name carries a
hash of its source, the shared headers and the flags, so an edited source
or header is rebuilt.  The
compiler's output, with the ``-Xptxas -v`` register and spill lines, is
kept in ``build_log()``.

The Python side of every C entry point the port calls is here too:
``ENTRY_POINTS`` gives each its source, argument types and the messages of
its own return codes; ``entry`` returns it typed (once per loaded
library), ``size`` asks a size query once for each of its arguments,
``launch`` launches a kernel, checks its return code and counts the launch
in ``launches``, and ``check_tensor`` holds a tensor to what a kernel takes.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_log: list[str] = []


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> str:
    """The library's path: its name carries a hash of the source, of the
    shared headers (``csrc/*.cuh``) and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: list[str] | None = None) -> None:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process per source, started together."""
    names = sources() if names is None else names
    todo = [n for n in names if not os.path.exists(_target(n))]
    if not todo:
        return
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        out = _target(n)
        tmp = out + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, n + ".cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, out, tmp, p in procs:
        text, _ = p.communicate()
        _log.append(f"== nvcc {n}.cu (rc={p.returncode})\n{text}")
        if p.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(n)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(_log[-len(procs):]))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(_target(name))
        return _libs[name]


def build_log() -> str:
    return "\n".join(_log)


_P, _I = ctypes.c_void_p, ctypes.c_int
_OUT = ctypes.POINTER(ctypes.c_int)   # ints the entry point writes
_LSTM = {-1: "the kernel's grid cannot be co-resident on this card",
         -2: "shape not supported by the kernel (H must be a multiple of 16, "
             "at most 1024 in f32 and in bf16 past 64 rows)",
         -3: "the kernel's shared-memory request was refused (H too large)"}
_CRF = {-2: "shape not supported by the kernel (n_state <= 256, n_base + 1 "
            "<= 8, n_state * (n_base + 1) <= 2048; the Viterbi decode's "
            "kernels alone also take up to 1024 states and 5120 scores a "
            "frame)"}
_UNALIGNED = {-3: "scores not 8-byte aligned"}
_DECODE = {-2: "shape not supported by the Viterbi decode's kernels (n_base "
               "+ 1 <= 8, n_state a multiple of n_base, n_state <= 1024 and "
               "n_state * (n_base + 1) <= 5120; past 256 states or 2048 "
               "scores a frame on their wide path)", **_UNALIGNED}
_LATTICE = {-2: "lattice not supported by the kernel (1 <= n <= 6144 "
                "positions)",
            -3: "packed lattice or alphas not 16-byte aligned"}


class Entry(NamedTuple):
    source: str                 # csrc/<source>.cu
    argtypes: list
    messages: dict[int, str]    # its own (negative) return codes
    path: str | None = None     # what the launch's last argument reports


# Every C entry point the port calls.  A launch's arguments end with the
# stream and, where it reports the path it took, an int it sets to 1 on
# that path; the size queries return sizes, not codes.
ENTRY_POINTS = {
    "xna_lstm_recurrence": Entry(
        "lstm_recurrence", [_P] * 6 + [_I] * 6 + [_P, _OUT], _LSTM, "wide"),
    "xna_lstm_backward": Entry(
        "lstm_backward", [_P] * 9 + [_I] * 6 + [_P],
        {**_LSTM, -2: "shape not supported by the kernel (H must be a "
                      "multiple of 16, of 32 in bf16)"}),
    "xna_lstm_int8": Entry(
        "lstm_int8", [_P] * 6 + [_I] * 6 + [_P],
        {**_LSTM, -2: "shape not supported by the kernel (H must be a "
                      "multiple of 32)"}),
    "xna_lstm_group_rows": Entry("lstm_recurrence", [_I], {}),
    "xna_lstm_backward_group_rows": Entry("lstm_backward", [_I], {}),
    "xna_lstm_int8_group_rows": Entry("lstm_int8", [], {}),
    "xna_lstm_hbuf_elems": Entry("lstm_recurrence", [_I, _I], {}),
    "xna_lstm_bf16_geometry": Entry("lstm_recurrence", [_I, _I, _OUT], _LSTM),
    "xna_lstm_f32_geometry": Entry("lstm_recurrence", [_I, _I, _OUT], _LSTM),
    "xna_crf_backward": Entry(
        "crf_decode", [_P, _P] + [_I] * 4 + [_P, _OUT], _DECODE, "wide"),
    "xna_crf_fwd_viterbi": Entry(
        "crf_decode", [_P] * 5 + [_I] * 4 + [_P, _OUT], _DECODE, "wide"),
    "xna_crf_fwd_viterbi_qual": Entry(
        "crf_decode", [_P] * 6 + [_I] * 4 + [_P], {**_CRF, **_UNALIGNED}),
    "xna_crf_traceback": Entry(
        "crf_decode", [_P] * 3 + [_I] * 4 + [_P, _OUT], _DECODE, "wide"),
    "xna_crf_traceback_qual": Entry(
        "crf_decode", [_P] * 5 + [_I] * 4 + [_P], _CRF),
    "xna_crf_beam": Entry(
        "crf_beam", [_P] * 7 + [_I] * 5 + [_P],
        {**_CRF, -4: "beam width outside 1..256 (kMaxBeam)"}),
    "xna_crf_forward": Entry(
        "crf_loss", [_P] * 3 + [_I] * 4 + [_P], {**_CRF, **_UNALIGNED}),
    "xna_crf_posteriors": Entry("crf_loss", [_P] * 6 + [_I] * 4 + [_P], _CRF),
    "xna_lattice_forward": Entry(
        "crf_loss", [_P] * 4 + [_I] * 3 + [_P], _LATTICE),
    "xna_lattice_backward": Entry(
        "crf_loss", [_P] * 7 + [_I] * 3 + [_P], _LATTICE),
    "xna_lattice_depth": Entry("crf_loss", [_I, _I], {}),
    "xna_crf_head_epilogue": Entry(
        "crf_head", [_P, _P, _P, ctypes.c_longlong, _I, _I, _I,
                     ctypes.c_float, ctypes.c_float, _I, _P, _OUT],
        {-2: "shape not supported by the CRF head's kernel (rows, columns "
             "and n_base >= 1; with a blank score, columns a multiple of "
             "n_base; at most 2^31 - 1 blocks of 256 units)"}, "tiled"),
}

# Kernel launches by wrapper (``launches["backward_scan"]``), and those
# that took a path the launch reports, by wrapper and path
# (``launches["backward_scan.wide"]``).
launches: collections.Counter = collections.Counter()
_count_lock = threading.Lock()


@functools.cache
def entry(name: str, lib: ctypes.CDLL | None = None):
    """The C function ``name`` of ``lib`` (default: this tree's library of
    its source, built at first use), typed from ``ENTRY_POINTS``; cached,
    so each function is typed once per loaded library."""
    if lib is None:
        return entry(name, load(ENTRY_POINTS[name].source))
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = ENTRY_POINTS[name].argtypes, ctypes.c_int
    return fn


@functools.cache
def size(name: str, *args: int) -> int:
    """The answer of the size query ``name`` for ``args``: a constant of
    the library's build and the card, so asked once for each."""
    return entry(name)(*args)


@functools.cache
def _error_string(lib: ctypes.CDLL):
    fn = lib.xna_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise if the entry point ``name`` returned non-zero: its own codes
    are negative (``ENTRY_POINTS``' messages), CUDA's are ``cudaError_t``
    values, named by the library's ``xna_error_string``."""
    if rc == 0:
        return
    e = ENTRY_POINTS[name]
    if rc in e.messages:
        raise RuntimeError(f"{what}: {e.messages[rc]}")
    text = _error_string(load(e.source))(rc).decode()
    raise RuntimeError(f"{what}: CUDA error {rc} ({text})")


def launch(wrapper: str, name: str, *args, also: str | None = None) -> None:
    """Launch the entry point ``name`` on the current stream with ``args``
    (a tensor passes its data pointer), the stream and, where the entry
    point reports a path, the int it sets; raise on a non-zero return;
    count ``launches[wrapper]``, on the reported path
    ``launches[f"{wrapper}.{path}"]``, and ``launches[f"{wrapper}.{also}"]``
    for a path the wrapper chose itself."""
    path = ENTRY_POINTS[name].path
    took = ctypes.c_int(0)
    rc = entry(name)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        torch.cuda.current_stream().cuda_stream,
        *((ctypes.byref(took),) if path else ()))
    check(name, rc, wrapper)
    with _count_lock:
        launches[wrapper] += 1
        if took.value:
            launches[f"{wrapper}.{path}"] += 1
        if also:
            launches[f"{wrapper}.{also}"] += 1


def check_device(name: str, t: torch.Tensor) -> None:
    """Raise unless the CUDA tensor ``t`` is on the current device: the
    kernels launch there, on its current stream (``torch.cuda.device``
    sets it)."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name}: the tensor is on {t.device}, the current device is "
            f"cuda:{torch.cuda.current_device()} (use torch.cuda.device)")


def check_tensor(what: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, contiguous: bool = True) -> None:
    """Raise unless the tensor ``t`` (``name`` of ``what``'s arguments) is
    a CUDA tensor on the current device, of ``dtype`` and ``shape`` (a
    ``None`` there takes any size), and contiguous unless told not."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor for {name}, got "
                         f"{t.device}")
    check_device(f"{what}: {name}", t)
    if t.dtype != dtype or t.ndim != len(shape) or any(
            want is not None and want != got
            for want, got in zip(shape, t.shape)) \
            or (contiguous and not t.is_contiguous()):
        want = ", ".join("*" if n is None else str(n) for n in shape)
        raise ValueError(
            f"{what}: expected {name} {dtype} [{want}]"
            f"{' contiguous' if contiguous else ''}, got {t.dtype} "
            f"{list(t.shape)} contiguous={t.is_contiguous()}")
