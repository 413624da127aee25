"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exports plain C functions (no PyTorch headers), so
one ``nvcc`` call per source takes seconds.  Sources are compiled at first
use, never at import, for ``sm_90a`` (Hopper), all in parallel, into
``build/`` beside this package's sources; a library's file name carries a
hash of its source and flags, so an edited source is rebuilt.  The
compiler's output, with the ``-Xptxas -v`` register and spill lines, is
kept in ``build_log()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

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
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
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


def check(lib: ctypes.CDLL, rc: int, what: str,
          messages: dict[int, str] | None = None):
    """Raise if a C entry point returned non-zero: its own codes are
    negative (``messages``), CUDA's are ``cudaError_t`` values, named by
    the library's ``xna_error_string``."""
    if rc == 0:
        return
    if messages and rc in messages:
        raise RuntimeError(f"{what}: {messages[rc]}")
    fn = lib.xna_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{what}: CUDA error {rc} ({fn(rc).decode()})")
