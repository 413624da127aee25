"""The port's native library (``utils/native.py``) against the JAX
package's: both load ``native/xna_native.cpp``, each built into its own
package, so every result must be equal (exact: integer scores, cigars,
bounds, edit distances, DTW indices).  With the library made unavailable
(the port's ``_load`` patched), each caller's numpy fallback must equal
the JAX package's numpy fallback, also exactly.  The build writes a
temporary file and renames it into place, so that a process loading the
library never sees it half written."""

import ctypes
import os
import threading

import numpy as np
import pytest

from xna_basecaller_tpu.eval import accuracy as jaccuracy
from xna_basecaller_tpu.eval import cs_align as jcs_align
from xna_basecaller_tpu.tools import dtw_segmentation as jdtw
from xna_basecaller_tpu.utils import native as jnative
from xna_basecaller_tpu_torch.eval import accuracy
from xna_basecaller_tpu_torch.tools import dtw_segmentation as dtw
from xna_basecaller_tpu_torch.utils import native

SEEDS = range(4)
BASES = np.array(list("ACGTXYN"))


@pytest.fixture()
def no_native(monkeypatch):
    """Both packages without their library: the numpy fallbacks run."""
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "available", lambda: False)


def _pair(seed):
    """A random query and a reference that shares a mutated stretch of
    it, over ACGTXYN."""
    rng = np.random.default_rng(seed)
    q = "".join(rng.choice(BASES, size=int(rng.integers(20, 120))))
    mid = list(q[5:-5])
    for i in rng.choice(len(mid), size=len(mid) // 8, replace=False):
        mid[i] = str(rng.choice(BASES))
    r = ("".join(rng.choice(BASES, size=int(rng.integers(0, 30))))
         + "".join(mid)
         + "".join(rng.choice(BASES, size=int(rng.integers(0, 30)))))
    return q, r


def _squiggle(seed, R=40):
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=R).astype(np.float32)
    dwells = rng.integers(2, 8, size=R)
    query = (np.repeat(ref, dwells)
             + rng.normal(scale=0.3, size=int(dwells.sum()))
             ).astype(np.float32)
    return query, ref


def test_library_is_the_ports_own():
    """Built from the shared source into the port's ignored ``build/``,
    never into the JAX package."""
    assert native.available() and jnative.available()
    assert native._LIB_PATH == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(native.__file__))),
        "build", "xna_native.so")
    assert os.path.exists(native._LIB_PATH)
    assert native._LIB_PATH != jnative._LIB_PATH
    assert native._SRC == jnative._SRC


def test_build_renames_a_complete_library_into_place(tmp_path,
                                                     monkeypatch):
    """Threads that build into one path while another loads it: every
    load finds a whole library, and no temporary file is left."""
    lib = str(tmp_path / "build" / "lib.so")
    monkeypatch.setattr(native, "_LIB_PATH", lib)
    loads, stop = [], threading.Event()

    def load():
        while not stop.is_set():
            if os.path.exists(lib):
                loads.append(ctypes.CDLL(lib).levenshtein is not None)

    loader = threading.Thread(target=load)
    loader.start()
    threads = [threading.Thread(target=native._build) for _ in range(3)]
    try:
        for b in threads:
            b.start()
        for b in threads:
            b.join(timeout=300)
    finally:
        stop.set()
        loader.join(timeout=60)
    assert not any(b.is_alive() for b in threads) and not loader.is_alive()
    assert os.listdir(tmp_path / "build") == ["lib.so"]
    assert loads and all(loads)


def test_failed_build_leaves_nothing(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "lib.so"))
    assert native._build() is False
    assert os.listdir(tmp_path) == ["bad.cpp"]


@pytest.mark.parametrize("seed", SEEDS)
def test_sw_align_matches_jax(seed):
    q, r = _pair(seed)
    assert native.sw_align(q, r) == jnative.sw_align(q, r)
    assert accuracy.sw_align(q, r) == jaccuracy.sw_align(q, r)
    assert native.sw_align(q, "") == jnative.sw_align(q, "")


@pytest.mark.parametrize("seed", SEEDS)
def test_sw_score_batch_matches_jax(seed):
    q, r = _pair(seed)
    refs = [r, _pair(seed + 10)[1], "", r[::-1], q]
    got = native.sw_score_batch(q, refs)
    np.testing.assert_array_equal(got, jnative.sw_score_batch(q, refs))
    assert got.dtype == np.int32
    # the scores are sw_align's
    assert [int(s) for s in got] == [native.sw_align(q, t)[0] for t in refs]


@pytest.mark.parametrize("seed", SEEDS)
def test_dtw_band_matches_jax(seed):
    query, ref = _squiggle(seed)
    for band in (None, 6.0):
        got = native.dtw_band(query, ref, band)
        np.testing.assert_array_equal(got, jnative.dtw_band(query, ref,
                                                            band))
        np.testing.assert_array_equal(
            dtw.dtw_band_align(query, ref, band=band),
            jdtw.dtw_band_align(query, ref, band=band))
    assert native.dtw_band(query[:10], ref) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_levenshtein_matches_jax(seed, monkeypatch):
    q, r = _pair(seed)
    for a, b in ((q, r), (r, q), ("", q), (q, q)):
        d = native.levenshtein(a, b)
        assert d == jnative.levenshtein(a, b)
        with monkeypatch.context() as m:
            m.setattr(jnative, "available", lambda: False)
            assert d == jcs_align.levenshtein(a, b)


def test_unavailable_library(no_native):
    assert not native.available()
    assert native.sw_score_batch("ACGT", ["ACGT"]) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_sw_align_fallback_matches_jax(seed, no_native):
    q, r = _pair(seed)
    got = accuracy.sw_align(q, r)
    assert got == jaccuracy.sw_align(q, r)
    assert got[0] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_dtw_fallback_matches_jax(seed, no_native):
    query, ref = _squiggle(seed)
    for band in (None, 6.0):
        got = dtw.dtw_band_align(query, ref, band=band)
        np.testing.assert_array_equal(
            got, jdtw.dtw_band_align(query, ref, band=band))
    assert dtw.dtw_band_align(query[:10], ref) is None
