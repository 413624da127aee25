"""The port's ``tools/dtw_segmentation.py`` against the JAX package's, on
the cases of ``tests/test_dtw.py``: the same DTW indices, breakpoints and
success flags (exact), ``breakpoints.npy`` byte-equal to JAX's through
the native library and through the numpy recursion, with ``naive``,
``n_proc=2``, ``suffix``, ``limit``, ``overwrite`` and ``ubs_map``; and
the port's ``ChunkDataset`` and stitch donor tables read the port's
breakpoints as they read JAX's."""

import numpy as np
import pytest

from xna_basecaller_tpu.data.ctc_data import save_ctc_data
from xna_basecaller_tpu.data.pore_model import load_pore_model as jax_pore
from xna_basecaller_tpu.data.simulate import random_sequence, simulate_squiggle
from xna_basecaller_tpu.tools import dtw_segmentation as jdtw
from xna_basecaller_tpu.utils import native as jnative
from xna_basecaller_tpu_torch.augment.stitch import slice_xna_tables
from xna_basecaller_tpu_torch.data.ctc_data import load_datasets
from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
from xna_basecaller_tpu_torch.data.simulate import simulate_donor_dataset
from xna_basecaller_tpu_torch.tools import dtw_segmentation as dtw
from xna_basecaller_tpu_torch.utils import native


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def maybe_native(request, monkeypatch):
    """Both packages with their native library, or both without it."""
    if not request.param:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "available", lambda: False)
    return request.param


def _quiet(*a):
    pass


def test_dtw_band_align_exact_steps(maybe_native):
    ref = np.array([0.0, 5.0, -3.0, 2.0], np.float32)
    dwells = [3, 2, 4, 2]
    query = np.repeat(ref, dwells) + 0.01
    idx = dtw.dtw_band_align(query, ref)
    np.testing.assert_array_equal(idx, jdtw.dtw_band_align(query, ref))
    np.testing.assert_array_equal(np.bincount(idx, minlength=len(ref)),
                                  dwells)


def test_dtw_no_path_when_query_short(maybe_native):
    assert dtw.dtw_band_align(np.zeros(3, np.float32),
                              np.zeros(5, np.float32)) is None


@pytest.mark.parametrize("chunksize,length", [(3600, 350), (900, 120),
                                              (100, 100)])
def test_naive_breakpoints_match_jax(chunksize, length):
    bk = dtw.naive_breakpoints(chunksize, length)
    np.testing.assert_array_equal(bk, jdtw.naive_breakpoints(chunksize,
                                                             length))
    assert bk[-1] == chunksize and len(bk) == length


def test_reference_squiggle_matches_jax():
    rng = np.random.default_rng(2)
    codes = random_sequence(rng, 60, ub_prop=0.1)
    np.testing.assert_array_equal(
        dtw.reference_squiggle(codes, load_pore_model()),
        jdtw.reference_squiggle(codes, jax_pore()))


@pytest.mark.parametrize("ubs_map", [None, "GC"])
def test_segment_read_matches_jax(ubs_map, maybe_native):
    rng = np.random.default_rng(0)
    codes = random_sequence(rng, 80, ub_prop=0.05)
    signal, true_bk = simulate_squiggle(codes, jax_pore(), rng,
                                        noise_std=0.3)
    T = int(true_bk[-1])
    for window in (None, 4.0):
        bk, ok = dtw.segment_read(signal[:T], len(codes), codes,
                                  load_pore_model(), ref_rep=3,
                                  window_size=window, ubs_map=ubs_map)
        want, ok_j = jdtw.segment_read(signal[:T], len(codes), codes,
                                       jax_pore(), ref_rep=3,
                                       window_size=window, ubs_map=ubs_map)
        assert ok and ok_j
        np.testing.assert_array_equal(bk, want)
        assert bk[-1] == T
        err = np.abs(bk.astype(int) - true_bk.astype(int))
        assert np.median(err) <= 3 and np.mean(err) <= 6


def test_segment_read_naive_fallback(maybe_native):
    chunk = np.zeros(60, np.float32)
    codes = np.ones(50, np.uint8)
    bk, ok = dtw.segment_read(chunk, 50, codes, load_pore_model(),
                              ref_rep=3)
    want, _ = jdtw.segment_read(chunk, 50, codes, jax_pore(), ref_rep=3)
    assert not ok and bk[-1] == 60
    np.testing.assert_array_equal(bk, want)


def _ctc_dir(path, n=4, chunk_len=900, seed=1):
    """``tests/test_dtw.py``'s directory: simulated chunks cropped to the
    bases that lie inside them; one chunk with too many bases for its
    samples, whose DTW fails."""
    pore = jax_pore()
    rng = np.random.default_rng(seed)
    chunks = np.zeros((n, chunk_len), np.float16)
    refs = np.zeros((n, 400), np.uint8)
    lens = np.zeros(n, np.uint16)
    for i in range(n):
        codes = random_sequence(rng, 120, ub_prop=0.05)
        signal, bk = simulate_squiggle(codes, pore, rng)
        L = int(np.searchsorted(bk, chunk_len, "right"))
        chunks[i, : min(len(signal), chunk_len)] = \
            signal[:chunk_len].astype(np.float16)
        refs[i, :L] = codes[:L]
        lens[i] = L
    refs[-1] = rng.integers(1, 5, size=400)
    lens[-1] = 400
    save_ctc_data(str(path), chunks, refs, lens)
    return str(path)


@pytest.mark.parametrize("kw", [{}, {"naive": True}, {"n_proc": 2},
                                {"suffix": "w4", "window_size": 4.0},
                                {"limit": 2, "ubs_map": "GC"}],
                         ids=["dtw", "naive", "pool", "suffix", "limit"])
def test_dtw_segmentation_directory_matches_jax(kw, tmp_path, maybe_native):
    port = _ctc_dir(tmp_path / "port")
    jax = _ctc_dir(tmp_path / "jax")
    bkps, ok = dtw.dtw_segmentation(port, log=_quiet, **kw)
    want, ok_j = jdtw.dtw_segmentation(jax, log=_quiet, **kw)
    name = "breakpoints" + ("-naive" if kw.get("naive") else "") + (
        f"-{kw['suffix']}" if "suffix" in kw else "") + ".npy"
    assert (tmp_path / "port" / name).read_bytes() \
        == (tmp_path / "jax" / name).read_bytes()
    np.testing.assert_array_equal(bkps, want)
    np.testing.assert_array_equal(ok, ok_j)
    assert bkps.dtype == np.uint16
    n = kw.get("limit") or 4
    assert bkps.shape == (n, 400) and len(ok) == n
    if not kw.get("naive"):
        assert ok[: min(n, 3)].sum() >= min(n, 3) - 1
    # the file exists: skipped unless overwrite
    assert dtw.dtw_segmentation(port, log=_quiet, **kw) == (None, None)
    again, _ = dtw.dtw_segmentation(port, log=_quiet, overwrite=True, **kw)
    np.testing.assert_array_equal(again, bkps)


def test_breakpoints_feed_the_datasets_and_stitch_tables(tmp_path):
    """Donor ctc-data segmented by each package: the port's loaders and
    stitch tables read both directories alike."""
    for d in ("port", "jax"):
        save_ctc_data(str(tmp_path / d), *simulate_donor_dataset(
            12, chunk_len=600, seed=5)[:3])
    dtw.dtw_segmentation(str(tmp_path / "port"), log=_quiet)
    jdtw.dtw_segmentation(str(tmp_path / "jax"), log=_quiet)
    got = load_datasets(str(tmp_path / "port"), load_bkps=True)
    want = load_datasets(str(tmp_path / "jax"), load_bkps=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.breakpoints, b.breakpoints)
        np.testing.assert_array_equal(a.targets, b.targets)
    tp = slice_xna_tables(str(tmp_path / "port"), cap=4)
    tj = slice_xna_tables(str(tmp_path / "jax"), cap=4)
    for f in ("signals", "lens", "counts"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(tj, f))
    assert tp.counts.sum() > 0
