"""The port's spike augmentation (``augment/spike.py``, on the CPU) against
the JAX package's.

The two draw other random bits, so parity is exact where no draw enters
the result and by distribution elsewhere (PARITY.md, the RNG item).
Tolerances: where no draw enters (k-mer stds 0, no noise, chunks of 21
bases whose only valid position is 10, one UB code) targets equal and
chunks within 1e-6 relative (an f32 ulp of the normalised level: XLA may
fuse the division); k-mer codes, med/MAD and the spike count's f32
rounding exact.  Distributions on a seeded batch of 64: the mean UB count
per chunk within 0.5, the spiked samples' mean within 0.05 and std within
3 % of JAX's (seed to seed both packages spread ~0.01 and ~1 %); the
within-event std families over 4096 x 160 draws: mean within 0.02 (the
shift modes draw one shift per row, std 0.35/64) and std within 1 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.augment import spike as jspike
from xna_basecaller_tpu_torch.augment import spike
from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
from xna_basecaller_tpu_torch.data.simulate import simulate_ctc_dataset


@pytest.fixture(scope="module")
def pore():
    return load_pore_model()


@pytest.fixture(scope="module")
def dataset():
    c, t, l, b = simulate_ctc_dataset(8, chunk_len=1800, target_len=200,
                                      seed=3)
    return (c.astype(np.float32), t.astype(np.int32), l.astype(np.int32),
            b.astype(np.int32))


def _port(dataset, pore, seed=0, stds=None, **kw):
    g = torch.Generator().manual_seed(seed)
    c, t = spike.spike_batch(
        g, *(torch.from_numpy(a) for a in dataset),
        torch.from_numpy(pore.means),
        torch.from_numpy(pore.stds if stds is None else stds), **kw)
    return c.numpy(), t.numpy()


def _jax(dataset, pore, seed=0, stds=None, **kw):
    c, t = jspike.spike_batch(
        jax.random.key(seed), *(jnp.asarray(a) for a in dataset),
        jnp.asarray(pore.means),
        jnp.asarray(pore.stds if stds is None else stds), **kw)
    return np.asarray(c), np.asarray(t)


def _fixed_batch(seed=0, B=8, L=30, T=400):
    """Natural targets of 21 bases (position 10 is the only one 10 bases
    from either end) with differing signals and breakpoints."""
    rng = np.random.default_rng(seed)
    targets = rng.integers(1, 5, size=(B, L)).astype(np.int32)
    targets[:, 21:] = 0
    bkps = np.cumsum(rng.integers(3, 15, size=(B, L)), 1).astype(np.int32)
    bkps[:, 21:] = 0
    chunks = rng.normal(size=(B, T)).astype(np.float32)
    return chunks, targets, np.full(B, 21, np.int32), bkps


@pytest.mark.parametrize("ub_codes", [(5,), (6,), (0,)])
@pytest.mark.parametrize("fully_synth", [False, True])
def test_spike_batch_matches_jax_where_no_draw_enters(pore, fully_synth,
                                                      ub_codes):
    batch = _fixed_batch()
    stds = np.zeros_like(pore.stds)
    kw = dict(noise_std=0.0, fully_synth=fully_synth, ub_codes=ub_codes)
    c, t = _port(batch, pore, stds=stds, **kw)
    cj, tj = _jax(batch, pore, stds=stds, **kw)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_allclose(c, cj, rtol=1e-6, atol=1e-6)
    # the spike was made: the signal changed, the target only at 10
    assert (np.abs(c - batch[0]) > 1e-6).any(axis=1).all()
    changed = t != batch[1]
    if ub_codes == (0,):
        assert not changed.any()
    else:
        assert changed[:, 10].all() and changed.sum() == len(t)


def test_kmer_codes_match_jax(pore):
    rng = np.random.default_rng(0)
    targets = rng.integers(1, 7, size=(5, 40)).astype(np.int32)
    got = spike._kmer_codes_from_target(torch.from_numpy(targets)).numpy()
    want = np.stack([np.asarray(jspike._kmer_codes_from_target(
        jnp.asarray(row))) for row in targets])
    np.testing.assert_array_equal(got, want)
    # position 8 of ACGTACGTXACG starts with X; the tail runs into AT
    row = np.array([[1, 2, 3, 4, 1, 2, 3, 4, 5, 1, 2, 3]], np.int32)
    codes = spike._kmer_codes_from_target(torch.from_numpy(row))[0]
    assert codes[0] == pore.kmer_code("ACGTAC")
    assert codes[8] == pore.kmer_code("XACGAT")


@pytest.mark.parametrize("n_valid", [1, 2, 7, 8, 20, 21, 40])
def test_med_mad_matches_jax(pore, n_valid):
    """The masked median over L x 8 entries (an even count) is the mean of
    the two middle values, as jnp.median gives it; stds 0 so no draw."""
    rng = np.random.default_rng(n_valid)
    L = 40
    means = pore.means[rng.integers(0, len(pore.means), size=(3, L))]
    valid = np.arange(L)[None] < np.array([n_valid, max(1, n_valid - 1),
                                           L])[:, None]
    med, mad = spike._med_mad_squiggly(
        torch.Generator(), torch.from_numpy(means),
        torch.zeros(means.shape), torch.from_numpy(valid))
    for i in range(3):
        mj, dj = jspike._med_mad_squiggly(
            jax.random.key(0), jnp.asarray(means[i]),
            jnp.zeros(L, jnp.float32), jnp.asarray(valid[i]))
        assert med[i].item() == float(mj) and mad[i].item() == float(dj)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 9, 16])
def test_median_is_jax_median(n):
    x = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    got = spike._median(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.median(x, axis=1)))
    assert spike._median(torch.tensor([1.0, 2.0, 3.0, 4.0])).item() == 2.5


@pytest.mark.parametrize("prop", [0.01, 0.05, 0.08, 0.1, 0.15, 0.2, 0.25])
def test_n_positions_rounds_as_jax(prop):
    """round(length * prop) in f32, half to even, over lengths 1..500."""
    lengths = np.arange(1, 501, dtype=np.int32)
    want = np.minimum(np.maximum(np.asarray(jnp.round(
        jnp.asarray(lengths) * prop).astype(jnp.int32)) - 3, 1), 64)
    got = spike._n_positions(torch.from_numpy(lengths), prop,
                             torch.full((500,), 3), 64).numpy()
    np.testing.assert_array_equal(got, want)
    # with the per-item jitter the product is f32 by f32
    jitter = np.random.default_rng(0).uniform(
        prop - 0.01, prop + 0.01, 500).astype(np.float32)
    want = np.asarray(jnp.round(jnp.asarray(lengths) * jnp.asarray(
        jitter)).astype(jnp.int32))
    got = spike._n_positions(torch.from_numpy(lengths),
                             torch.from_numpy(jitter), torch.zeros(500),
                             10 ** 6).numpy()
    np.testing.assert_array_equal(got, np.maximum(want, 1))


def _inserted_count(dataset, t, c):
    _, refs, lens, _ = dataset
    for i in range(len(lens)):
        L = int(lens[i])
        n_ub = int((t[i, :L] > 4).sum())
        assert max(1, int(0.05 * L)) <= n_ub <= int(0.15 * L) + 2
        changed = t[i, :L] != refs[i, :L]
        assert np.all(t[i, :L][changed] > 4)
        np.testing.assert_array_equal(t[i, L:], refs[i, L:])


def _spacing_and_edges(dataset, t, c):
    _, refs, lens, _ = dataset
    for i in range(len(lens)):
        L = int(lens[i])
        new = np.where((t[i, :L] > 4) & (refs[i, :L] <= 4))[0]
        assert len(new) > 1 and np.min(np.diff(new)) > 5
        assert np.all(new >= 10) and np.all(new < L - 10)


def _signal_only_in_spans(dataset, t, c):
    chunks, refs, lens, bkps = dataset
    for i in range(len(lens)):
        L = int(lens[i])
        new = np.where((t[i, :L] > 4) & (refs[i, :L] <= 4))[0]
        changed = np.where(np.abs(c[i] - chunks[i]) > 1e-6)[0]
        assert len(changed) > 0
        spans = [(int(bkps[i, p - 6]) if p >= 6 else 0, int(bkps[i, p]))
                 for p in new]
        for s in changed:
            assert any(lo <= s < hi for lo, hi in spans), (s, spans)
    assert np.isfinite(c).all() and np.abs(c).max() < 20


def _whole_chunk(dataset, t, c):
    chunks, _, lens, bkps = dataset
    for i in range(len(lens)):
        total = int(bkps[i, int(lens[i]) - 1])
        assert np.mean(np.abs(c[i, :total] - chunks[i, :total]) > 1e-6) > 0.95
        np.testing.assert_array_equal(c[i, total:], chunks[i, total:])


def _one_code(dataset, t, c):
    assert set(np.unique(t[t > 4])) == {5}


def _one_type_per_chunk(dataset, t, c):
    refs = dataset[1]
    kinds = [set(row[(row > 4) & (ref <= 4)].tolist())
             for row, ref in zip(t, refs)]
    assert all(len(k) == 1 for k in kinds)
    assert len(set().union(*kinds)) == 2


def _counts_vary(dataset, t, c):
    assert len({int((row > 4).sum()) for row in t}) > 1


def _signal_only(dataset, t, c):
    np.testing.assert_array_equal(t, dataset[1])
    assert (np.abs(c - dataset[0]) > 1e-6).any(axis=1).all()


@pytest.mark.parametrize("check, kw", [
    (_inserted_count, dict(prop_ubs=0.10, ub_codes=(5, 6))),
    (_spacing_and_edges, dict(prop_ubs=0.10, pad=5)),
    (_signal_only_in_spans, dict(prop_ubs=0.08, noise_std=0.5)),
    (_whole_chunk, dict(prop_ubs=0.10, fully_synth=True)),
    (_one_code, dict(prop_ubs=0.10, ub_codes=(5,))),
    (_one_type_per_chunk, dict(prop_ubs=0.10, mix_ubs=False)),
    (_counts_vary, dict(prop_ubs=0.10, var_prop_ubs=0.08)),
    (_signal_only, dict(prop_ubs=0.10, ub_codes=(0,))),
], ids=lambda v: v.__name__.strip("_") if callable(v) else "")
def test_spike_properties(dataset, pore, check, kw):
    """The properties that tests/test_augment.py holds JAX's spike to."""
    t_c = _port(dataset, pore, **kw)
    check(dataset, t_c[1], t_c[0])


def test_spike_distribution_matches_jax(pore):
    data = tuple(a.astype(dt) for a, dt in zip(
        simulate_ctc_dataset(64, chunk_len=1800, target_len=200, seed=3),
        (np.float32, np.int32, np.int32, np.int32)))

    def stats(c, t):
        changed = np.abs(c - data[0]) > 1e-6
        return (t > 4).sum(1).mean(), c[changed].mean(), c[changed].std()

    n, mean, std = stats(*_port(data, pore, seed=0))
    nj, mean_j, std_j = stats(*_jax(data, pore, seed=0))
    assert abs(n - nj) <= 0.5
    assert abs(mean - mean_j) <= 0.05
    assert abs(std - std_j) <= 0.03 * std_j


@pytest.mark.parametrize("dist", ["uniform", "uniform_shift_1.5_0.5",
                                  "truncnorm_shift_1.5_0.5", "truncnorm",
                                  "normal"])
def test_std_dist_moments_match_jax(dist):
    ones = np.ones((4096, 160), np.float32)
    got = spike._sample_event_stds(torch.Generator().manual_seed(0),
                                   torch.from_numpy(ones), dist).numpy()
    want = np.asarray(jax.vmap(
        lambda k, s: jspike._sample_event_stds(k, s, dist))(
            jax.random.split(jax.random.key(0), 4096), jnp.asarray(ones)))
    assert abs(got.mean() - want.mean()) <= 0.02
    assert abs(got.std() - want.std()) <= 0.01 * want.std()
    with pytest.raises(ValueError):
        spike._sample_event_stds(torch.Generator(), torch.ones(3), "gamma")


def test_truncated_normal_stays_inside_uneven_bounds():
    lower = torch.tensor([[-2.0], [-1.0], [-0.5]])
    x = spike._truncated_normal(torch.Generator().manual_seed(1), lower,
                                lower + 3.0, (3, 20000), "cpu")
    assert (x > lower).all() and (x < lower + 3.0).all()
    # the mean of N(0, 1) on [-2, 1]: (phi(-2) - phi(1)) / mass = -0.2296
    assert x[0].mean().item() == pytest.approx(-0.2296, abs=0.02)


def test_small_pad_rejected(dataset, pore):
    with pytest.raises(ValueError, match="pad"):
        _port(dataset, pore, pad=3)


def test_make_spike_augment_closure(dataset):
    chunks, refs, lens, bkps = dataset
    aug = spike.make_spike_augment(ubs="XY", prop_ubs=0.10, device="cpu")
    rng = np.random.default_rng(0)
    c, t = aug(chunks, refs, lens, bkps, rng)
    assert c.shape == chunks.shape and c.dtype == np.float32
    assert t.shape == refs.shape and t.dtype == np.int32
    assert (t > 4).sum() > (refs > 4).sum()
    # the next draw of the dataset's rng -> another augmentation
    c2, t2 = aug(chunks, refs, lens, bkps, rng)
    assert not np.array_equal(t, t2)
    # the same rng state -> the same augmentation
    c3, t3 = aug(chunks, refs, lens, bkps, np.random.default_rng(0))
    np.testing.assert_array_equal(t3, t)
    np.testing.assert_array_equal(c3, c)


def test_make_spike_augment_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spike.make_spike_augment()


def test_choose_positions_counts_windows_and_none():
    """Exactly n_pos picks where there is room, spaced > pad, 10 bases from
    either end and outside the masked positions; -1 for the rest, and for
    rows with no valid position."""
    B, L, pad = 6, 80, 5
    lengths = torch.tensor([80, 80, 80, 80, 20, 15])
    n_pos = torch.tensor([1, 3, 64, 5, 2, 1])
    mask = torch.zeros(B, L, dtype=torch.bool)
    mask[3, 30:50] = True
    picks = spike._choose_positions(torch.Generator().manual_seed(0),
                                    lengths, n_pos, 64, pad, mask).numpy()
    made = picks >= 0
    assert made[0].sum() == 1 and made[1].sum() == 3 and made[3].sum() == 5
    # 60 valid positions, each pick closes at most 2 pad + 1 = 11
    assert 60 // 11 <= made[2].sum() <= 60 // 6 + 1
    assert made[4].sum() == 0 and made[5].sum() == 0  # no valid position
    assert (picks[~made] == -1).all()
    for i in range(4):
        p = np.sort(picks[i][made[i]])
        assert (p >= 10).all() and (p < 70).all()
        assert (np.diff(p) > pad).all()
    assert not ((picks[3] >= 30) & (picks[3] < 50)).any()


def test_choose_positions_draws_in_proportion_to_weights():
    """The first pick of each row follows the weights (2000 rows: within
    0.03 of each position's share)."""
    B, L = 2000, 24
    w = torch.zeros(L)
    w[10:14] = torch.tensor([1.0, 2.0, 0.0, 5.0])
    picks = spike._choose_positions(
        torch.Generator().manual_seed(1), torch.full((B,), L),
        torch.ones(B, dtype=torch.long), 3, 5,
        torch.zeros(B, L, dtype=torch.bool), weights=w.expand(B, L)).numpy()
    assert (picks[:, 1:] == -1).all()
    share = np.bincount(picks[:, 0], minlength=L) / B
    np.testing.assert_allclose(share[10:14], [0.125, 0.25, 0.0, 0.625],
                               atol=0.03)
    assert share.sum() == 1.0
