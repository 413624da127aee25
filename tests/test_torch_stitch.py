"""The port's stitch augmentation (``augment/stitch.py``, on the CPU)
against the JAX package's, on a donor library with the real library's
structure (single UB, mirrored 5-base context; ``simulate_donor_dataset``,
the construction of tests/test_stitch.py).

Tolerances: the host tables (``slice_xna_tables``, ``build_relax_fallback``,
``count_kmers``, ``load_kmer_weight_table``) bit-equal; the availability
mask exact; ``position_weights`` within 1e-6 relative (f32 logs and exp);
where no draw enters ``stitch_batch`` (cap 1: one candidate a bucket; 21
bases, so position 10 is the only one; one UB code; no noise, no permute)
targets and success equal and chunks within 1e-6 (an f32 ulp of the
interpolation, which XLA may fuse).  Distributions: the properties of
tests/test_stitch.py, and each noise mode's added mean within 0.02 and
std within 3 % of JAX's over 64 x 64 spans (one draw a span for the block
modes, so their spread is 1/64 of noise_std's range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.augment import stitch as jstitch
from xna_basecaller_tpu_torch.augment import stitch
from xna_basecaller_tpu_torch.data.ctc_data import save_ctc_data
from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
from xna_basecaller_tpu_torch.data.simulate import (
    MIRROR_HEX, simulate_donor_dataset, simulate_squiggle,
)


def write_donors(directory, n_reads=40, chunk_len=1200, seed=0):
    """A stitch donor directory: ``simulate_donor_dataset`` saved as
    ctc-data; returns its path."""
    save_ctc_data(str(directory), *simulate_donor_dataset(
        n_reads, chunk_len=chunk_len, seed=seed))
    return str(directory)


@pytest.fixture(scope="module")
def xna_dir(tmp_path_factory):
    return write_donors(tmp_path_factory.mktemp("xna_ctc"))


@pytest.fixture(scope="module")
def tables(xna_dir):
    return stitch.slice_xna_tables(xna_dir, cap=8)


def _acceptors(seed, B=4, L=120, chunk_len=2400, periodic=True, n=None):
    """Acceptor chunks: targets of the period-6 pattern (every position's
    rotated context has donors) or random DNA; ``n`` bases of them."""
    pore = load_pore_model()
    rng = np.random.default_rng(seed)
    n = L if n is None else n
    chunks = np.zeros((B, chunk_len), np.float32)
    refs = np.zeros((B, L), np.int32)
    bkps = np.zeros((B, L), np.int32)
    for i in range(B):
        target = (np.tile(MIRROR_HEX, n // 6 + 2)[i % 6: i % 6 + n]
                  if periodic else rng.integers(1, 5, size=n)
                  ).astype(np.uint8)
        signal, bk = simulate_squiggle(target, pore, rng)
        chunks[i, : min(len(signal), chunk_len)] = signal[:chunk_len]
        refs[i, :n] = target
        bkps[i, :n] = np.minimum(bk[:n], chunk_len)
    return chunks, refs, np.full(B, n, np.int32), bkps


def _tensors(tables, fallback=None):
    t = [torch.from_numpy(a) for a in (tables.signals, tables.lens,
                                       tables.counts)]
    return t, (None if fallback is None else torch.from_numpy(fallback))


def _port(batch, tables, seed=0, fallback=None, weights=None, **kw):
    (sig, lens, counts), fb = _tensors(tables, fallback)
    c, t, s = stitch.stitch_batch(
        torch.Generator().manual_seed(seed),
        *(torch.from_numpy(a) for a in batch), sig, lens, counts,
        tbl_fallback=fb, weight_table=weights, **kw)
    return c.numpy(), t.numpy(), s.numpy()


def _jax(batch, tables, seed=0, fallback=None, **kw):
    c, t, s = jstitch.stitch_batch(
        jax.random.key(seed), *(jnp.asarray(a) for a in batch),
        jnp.asarray(tables.signals), jnp.asarray(tables.lens),
        jnp.asarray(tables.counts),
        tbl_fallback=None if fallback is None else jnp.asarray(fallback),
        **kw)
    return np.asarray(c), np.asarray(t), np.asarray(s)


def test_donor_dataset_is_the_jax_tests_library(tmp_path):
    """``simulate_donor_dataset`` reproduces tests/test_stitch.py's
    fixture: the same reads from the same seed."""
    c, t, l, b = simulate_donor_dataset(40)
    for i in (0, 7, 39):
        n = int(l[i])
        assert n == 51 and t[i, 25] == (5 if (i // 6) % 2 == 0 else 6)
        np.testing.assert_array_equal(t[i, 20:25], t[i, 26:31])
    tbl = stitch.slice_xna_tables(write_donors(tmp_path), cap=8)
    for rot in range(6):
        ctx = MIRROR_HEX[(rot + 1 + np.arange(5)) % 6]
        assert tbl.counts[0, :, stitch._tpl_code(ctx)].sum() > 0


@pytest.mark.parametrize("cap", [8, 1])
def test_slice_xna_tables_match_jax(xna_dir, cap):
    got = stitch.slice_xna_tables(xna_dir, cap=cap)
    want = jstitch.slice_xna_tables(xna_dir, cap=cap)
    for k in ("signals", "lens", "counts"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert getattr(got, k).dtype == getattr(want, k).dtype
    assert got.cap == cap and got.counts.sum() > 0


def test_slice_xna_tables_reservoir_matches_jax(tmp_path):
    """More donors than cap: the reservoir draws from the numpy rng as
    JAX's does."""
    d = write_donors(tmp_path, n_reads=120, chunk_len=800, seed=5)
    got = stitch.slice_xna_tables(d, cap=2, seed=3)
    want = jstitch.slice_xna_tables(d, cap=2, seed=3)
    for k in ("signals", "lens", "counts"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("source", ["library", "sparse"])
def test_relax_fallback_matches_jax(tables, source):
    counts = tables.counts
    if source == "sparse":
        rng = np.random.default_rng(0)
        counts = np.where(rng.random(counts.shape) < 0.01,
                          rng.integers(1, 9, counts.shape), 0).astype(
                              np.int32)
        counts[1, 3] = 0          # a (ub, kup) with no donor at all
    np.testing.assert_array_equal(stitch.build_relax_fallback(counts),
                                  jstitch.build_relax_fallback(counts))


def test_tpl_code_base4():
    assert stitch._tpl_code(np.array([1, 1, 1, 1, 1])) == 0
    assert stitch._tpl_code(np.array([4, 4, 4, 4, 4])) == 1023
    assert stitch._tpl_code(np.array([1, 1, 1, 1, 2])) == 1


@pytest.fixture(scope="module")
def kmer_dir(tmp_path_factory):
    """Common pattern everywhere, one rare pattern in a single read."""
    d = tmp_path_factory.mktemp("kmers")
    n, L = 30, 60
    refs = np.zeros((n, L), np.uint8)
    refs[:] = np.tile(np.array([1, 2, 3, 4, 2, 3], np.uint8), L // 6 + 1)[:L]
    refs[0, 20:32] = np.array([4, 4, 1, 1, 3, 3] * 2, np.uint8)
    refs[1, 40] = 5               # a UB breaks the 6-mers around it
    save_ctc_data(str(d), np.zeros((n, 100), np.float16), refs,
                  np.full(n, L, np.uint16))
    return d


def test_kmer_counts_and_weight_table_match_jax(kmer_dir, tmp_path):
    got = stitch.count_kmers(str(kmer_dir))
    csv = (kmer_dir / "kmer_count-len_6.csv").read_text()
    want = jstitch.count_kmers(str(kmer_dir))
    np.testing.assert_array_equal(got, want)
    assert (kmer_dir / "kmer_count-len_6.csv").read_text() == csv
    table = stitch.load_kmer_weight_table(str(kmer_dir))
    np.testing.assert_array_equal(
        table, jstitch.load_kmer_weight_table(str(kmer_dir)))
    assert table.shape == (6, 1024) and table.dtype == np.float32
    # without the csv the table counts the k-mers first
    save_ctc_data(str(tmp_path), np.zeros((30, 100), np.float16),
                  np.load(kmer_dir / "references.npy"),
                  np.load(kmer_dir / "reference_lengths.npy"))
    np.testing.assert_array_equal(
        stitch.load_kmer_weight_table(str(tmp_path)), table)


def test_position_weights_match_jax(kmer_dir):
    table = stitch.load_kmer_weight_table(str(kmer_dir))
    refs = np.load(kmer_dir / "references.npy").astype(np.int32)[:4]
    lens = np.array([60, 60, 41, 12], np.int32)
    got = stitch.position_weights(torch.from_numpy(refs),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(table)).numpy()
    for i in range(4):
        want = np.asarray(jstitch.position_weights(
            jnp.asarray(refs[i]), jnp.int32(lens[i]), jnp.asarray(table)))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=0)
    # edges zeroed; the rare context outweighs the common one
    assert np.all(got[0, :5] == 0) and np.all(got[0, -5:] == 0)
    assert got[0, 23:29].max() > got[0, 40:50].max()


@pytest.mark.parametrize("relax", [False, True])
@pytest.mark.parametrize("ub_codes", [(5,), (6,), (5, 6)])
def test_availability_mask_matches_jax(tables, ub_codes, relax):
    rng = np.random.default_rng(1)
    targets = np.concatenate([
        _acceptors(2, B=3, L=90, chunk_len=1200)[1],
        rng.integers(0, 7, size=(3, 90)).astype(np.int32)])
    lengths = np.array([90, 60, 33, 90, 45, 20], np.int32)
    fb = jstitch.build_relax_fallback(tables.counts) if relax else None
    got = stitch.availability_mask(
        torch.from_numpy(targets), torch.from_numpy(lengths),
        torch.from_numpy(tables.counts), ub_codes,
        tbl_fallback=None if fb is None else torch.from_numpy(fb)).numpy()
    for i in range(len(targets)):
        want = np.asarray(jstitch.availability_mask(
            jnp.asarray(targets[i]), jnp.int32(lengths[i]),
            jnp.asarray(tables.counts), ub_codes,
            tbl_fallback=None if fb is None else jnp.asarray(fb)))
        np.testing.assert_array_equal(got[i], want)
    assert got[:3].any()


@pytest.mark.parametrize("ub_codes", [(5,), (6,)])
@pytest.mark.parametrize("relax", [False, True])
def test_stitch_batch_matches_jax_where_no_draw_enters(xna_dir, relax,
                                                       ub_codes):
    """cap 1 and 21 bases: one candidate, one position, one code.  With
    relax the acceptors are random DNA, whose contexts reach donors only
    through the fallback."""
    tables = stitch.slice_xna_tables(xna_dir, cap=1)
    batch = _acceptors(3, B=8, L=30, chunk_len=600, periodic=not relax,
                       n=21)
    fb = stitch.build_relax_fallback(tables.counts) if relax else None
    c, t, s = _port(batch, tables, fallback=fb, ub_codes=ub_codes)
    cj, tj, sj = _jax(batch, tables, fallback=fb, ub_codes=ub_codes)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_array_equal(s, sj)
    np.testing.assert_allclose(c, cj, rtol=1e-6, atol=1e-6)
    assert s.all() and (t[:, 10] == ub_codes[0]).all()
    assert (np.abs(c - batch[0]) > 1e-6).any(axis=1).all()


def test_stitch_inserts_ubs_and_splices(tables):
    chunks, refs, lens, bkps = batch = _acceptors(1)
    c, t, success = _port(batch, tables, prop_ubs=0.08, ub_codes=(5, 6))
    assert success.all()
    for i in range(len(lens)):
        L = int(lens[i])
        new_ubs = np.where(t[i, :L] > 4)[0]
        assert len(new_ubs) >= 1
        assert np.all(new_ubs >= 10) and np.all(new_ubs < L - 10)
        assert np.min(np.diff(new_ubs)) > 5
        changed = np.where(np.abs(c[i] - chunks[i]) > 1e-6)[0]
        assert len(changed) > 0
        spans = [(int(bkps[i, p - 6]), int(bkps[i, p])) for p in new_ubs]
        for s in changed:
            assert any(lo <= s < hi for lo, hi in spans), (s, spans)
        keep = np.setdiff1d(np.arange(L), new_ubs)
        np.testing.assert_array_equal(t[i, keep], refs[i, keep])


def test_stitch_sparse_tables_skip_gracefully():
    """Empty tables -> no splice, chunk untouched, success False."""
    empty = stitch.StitchTables(
        np.zeros((2, 6, 1024, 4, 100), np.float32),
        np.zeros((2, 6, 1024, 4), np.int32),
        np.zeros((2, 6, 1024), np.int32))
    batch = _acceptors(1)
    c, t, success = _port(batch, empty, prop_ubs=0.08)
    assert not success.any()
    np.testing.assert_array_equal(c, batch[0])
    np.testing.assert_array_equal(t, batch[1])


def test_make_stitch_augment_refuses_empty_tables(tmp_path):
    """JAX trains on unaugmented data then; the port names the directory."""
    save_ctc_data(str(tmp_path), *simulate_donor_dataset(4)[:2],
                  np.zeros(4, np.uint16), np.zeros((4, 80), np.uint16))
    with pytest.raises(ValueError, match=str(tmp_path)):
        stitch.make_stitch_augment(str(tmp_path), device="cpu")


def test_one_code_table_still_inserts_with_xy(tables):
    x_only = stitch.StitchTables(
        tables.signals.copy(), tables.lens.copy(), tables.counts.copy())
    x_only.signals[1] = 0
    x_only.lens[1] = 0
    x_only.counts[1] = 0
    c, t, success = _port(_acceptors(1), x_only, seed=3, prop_ubs=0.08,
                          ub_codes=(5, 6))
    assert success.all()
    assert (t == 5).sum() > 0 and (t == 6).sum() == 0


def test_small_pad_rejected(tables):
    with pytest.raises(ValueError, match="pad"):
        _port(_acceptors(1), tables, pad=3)


def test_permute_transform_window_locality():
    sig = torch.arange(32, dtype=torch.float32).repeat(3, 1)
    out = stitch._permute_transform(torch.Generator().manual_seed(0), sig,
                                    torch.tensor([24, 24, 8]), 8).numpy()
    np.testing.assert_array_equal(out[:2, 24:], np.tile(np.arange(24, 32),
                                                         (2, 1)))
    np.testing.assert_array_equal(out[2, 8:], np.arange(8, 32))
    changed = False
    for w in range(3):
        win = out[0, w * 8:(w + 1) * 8]
        assert sorted(win.tolist()) == list(range(w * 8, (w + 1) * 8))
        changed |= not np.array_equal(win, np.arange(w * 8, (w + 1) * 8))
    assert changed


def test_stitch_relax_rescues_sparse_library(tables):
    """Random-DNA acceptors whose contexts are not in the donor tables:
    exact matching inserts ~nothing, relax the requested proportion."""
    batch = _acceptors(9, periodic=False)
    _, t_exact, _ = _port(batch, tables, prop_ubs=0.10)
    fb = stitch.build_relax_fallback(tables.counts)
    c_rel, t_rel, succ = _port(batch, tables, prop_ubs=0.10, fallback=fb)
    n_exact, n_rel = int((t_exact > 4).sum()), int((t_rel > 4).sum())
    assert n_rel > max(4 * n_exact, 4 * 4), (n_exact, n_rel)
    assert succ.all()
    assert not np.allclose(c_rel, batch[0])


def test_stitch_relax_noop_on_fully_available_contexts(tables):
    batch = _acceptors(1)
    c0, t0, s0 = _port(batch, tables, seed=3, prop_ubs=0.08)
    fb = stitch.build_relax_fallback(tables.counts)
    c1, t1, s1 = _port(batch, tables, seed=3, prop_ubs=0.08, fallback=fb)
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_array_equal(s0, s1)


def test_weighted_pick_favours_rare_contexts(kmer_dir, tables):
    """With the k-mer weight table the picks follow position_weights:
    none where the weight is 0 (the edges)."""
    table = torch.from_numpy(stitch.load_kmer_weight_table(str(kmer_dir)))
    batch = _acceptors(1)
    c, t, s = _port(batch, tables, prop_ubs=0.08, weights=table)
    w = stitch.position_weights(torch.from_numpy(batch[1]),
                                torch.from_numpy(batch[2]), table).numpy()
    new = t > 4
    assert new.any() and (w[new] > 0).all()


@pytest.mark.parametrize("mode", ["single", "single_variable", "block_add",
                                  "block_mult"])
def test_noise_modes_match_jax_moments(mode):
    sig = np.ones((64, 64, 360), np.float32)
    got = stitch._noise_transform(torch.Generator().manual_seed(0),
                                  torch.from_numpy(sig), 0.5, mode).numpy()
    keys = jax.random.split(jax.random.key(0), 64 * 64)
    want = np.asarray(jax.vmap(lambda k, s: jstitch._noise_transform(
        k, s, 0.5, mode))(keys, jnp.asarray(sig.reshape(-1, 360))))
    assert abs(got.mean() - want.mean()) <= 0.02
    assert abs(got.std() - want.std()) <= 0.03 * want.std()
    with pytest.raises(ValueError, match="noise mode"):
        stitch._noise_transform(torch.Generator(), torch.ones(3), 0.5, "x")
    assert stitch._noise_transform(None, torch.ones(3), 0.0, "x").eq(1).all()


def test_make_stitch_augment_closure(xna_dir):
    chunks, refs, lens, bkps = _acceptors(1)
    aug = stitch.make_stitch_augment(xna_dir, ubs="X", cap=8, device="cpu")
    rng = np.random.default_rng(2)
    c, t = aug(chunks, refs, lens, bkps, rng)
    assert c.dtype == np.float32 and t.dtype == np.int32
    assert (t > 4).sum() > 0 and set(np.unique(t[t > 4])) == {5}
    c2, t2 = aug(chunks, refs, lens, bkps, rng)
    assert not np.array_equal(c, c2)


def test_make_stitch_augment_needs_cuda_unless_asked_for_cpu(xna_dir):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stitch.make_stitch_augment(xna_dir)
