"""The spike and stitch augmentations on the card against the port's CPU
run.  Marked ``gpu``; each test skips where there is no CUDA device.

Run them on a machine with the card:
    python -m pytest tests/test_torch_augment_gpu.py -m gpu --noconftest

Where no draw enters the result (k-mer stds 0 and no noise for spike, one
donor a bucket for stitch; targets of 21 bases, so position 10 is the only
one; one UB code) the card's targets and success equal the CPU's and its
chunks are within 1e-6 (the same f32 operations; the card's erfinv and
division round as the CPU's or within an ulp).  Elsewhere the card draws
from its own generator, so the tests hold the properties that the CPU
tests hold.
"""

import numpy as np
import pytest
import torch

from xna_basecaller_tpu_torch.augment import spike, stitch
from xna_basecaller_tpu_torch.data.ctc_data import save_ctc_data
from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
from xna_basecaller_tpu_torch.data.simulate import (
    MIRROR_HEX, simulate_ctc_dataset, simulate_donor_dataset,
    simulate_squiggle,
)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pore():
    return load_pore_model()


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("xna_ctc")
    save_ctc_data(str(d), *simulate_donor_dataset(40))
    return {cap: stitch.slice_xna_tables(str(d), cap=cap) for cap in (1, 8)}


def _fixed_batch(B=64, L=450, T=3600, periodic=True, seed=0):
    """Targets of 21 bases (periodic: every context has donors) in chunks
    of T samples, breakpoints from the simulator."""
    pore = load_pore_model()
    rng = np.random.default_rng(seed)
    chunks = rng.normal(size=(B, T)).astype(np.float32)
    targets = np.zeros((B, L), np.int32)
    bkps = np.zeros((B, L), np.int32)
    for i in range(B):
        t = (np.tile(MIRROR_HEX, 6)[i % 6: i % 6 + 21] if periodic
             else rng.integers(1, 5, size=21)).astype(np.uint8)
        sig, bk = simulate_squiggle(t, pore, rng)
        targets[i, :21] = t
        bkps[i, :21] = np.minimum(bk[:21], T)
        chunks[i, :min(T, len(sig))] = sig[:T]
    return chunks, targets, np.full(B, 21, np.int32), bkps


def _on(device, arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("ub_codes", [(5,), (6,), (0,)])
@pytest.mark.parametrize("fully_synth", [False, True])
def test_spike_card_matches_cpu_where_no_draw_enters(cuda, pore,
                                                     fully_synth, ub_codes):
    batch = _fixed_batch()
    stds = np.zeros_like(pore.stds)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        c, t = spike.spike_batch(
            torch.Generator(device=dev).manual_seed(0), *_on(dev, batch),
            *_on(dev, (pore.means, stds)), noise_std=0.0,
            fully_synth=fully_synth, ub_codes=ub_codes)
        out[dev.type] = (c.cpu().numpy(), t.cpu().numpy())
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-6,
                               atol=1e-6)
    assert (np.abs(out["cuda"][0] - batch[0]) > 1e-6).any(axis=1).all()


@pytest.mark.parametrize("ub_codes", [(5,), (6,)])
@pytest.mark.parametrize("relax", [False, True])
def test_stitch_card_matches_cpu_where_no_draw_enters(cuda, tables, relax,
                                                      ub_codes):
    tbl = tables[1]
    batch = _fixed_batch(periodic=not relax)
    fb = (torch.from_numpy(stitch.build_relax_fallback(tbl.counts)).long()
          if relax else None)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        c, t, s = stitch.stitch_batch(
            torch.Generator(device=dev).manual_seed(0), *_on(dev, batch),
            *_on(dev, (tbl.signals, tbl.lens, tbl.counts)),
            ub_codes=ub_codes, tbl_fallback=None if fb is None else fb.to(dev))
        out[dev.type] = [x.cpu().numpy() for x in (c, t, s)]
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_array_equal(out["cuda"][2], out["cpu"][2])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-6,
                               atol=1e-6)
    assert out["cuda"][2].all() and (out["cuda"][1][:, 10] > 4).all()


@pytest.fixture(scope="module")
def dataset():
    c, t, l, b = simulate_ctc_dataset(64, chunk_len=3600, target_len=400,
                                      seed=3)
    return (c.astype(np.float32), t.astype(np.int32), l.astype(np.int32),
            b.astype(np.int32))


def _new_ubs_respect_the_rules(dataset, c, t, pad=5):
    chunks, refs, lens, bkps = dataset
    for i in range(len(lens)):
        L = int(lens[i])
        new = np.where((t[i, :L] > 4) & (refs[i, :L] <= 4))[0]
        assert len(new) >= 1
        assert np.all(new >= 10) and np.all(new < L - 10)
        if len(new) > 1:
            assert np.min(np.diff(new)) > pad
        spans = [(int(bkps[i, p - 6]), int(bkps[i, p])) for p in new]
        changed = np.where(np.abs(c[i] - chunks[i]) > 1e-6)[0]
        assert len(changed) > 0
        for s in changed:
            assert any(lo <= s < hi for lo, hi in spans), (s, spans)
        np.testing.assert_array_equal(t[i, L:], refs[i, L:])


def test_spike_properties_on_card(cuda, pore, dataset):
    c, t = spike.spike_batch(
        torch.Generator(device=cuda).manual_seed(1), *_on(cuda, dataset),
        *_on(cuda, (pore.means, pore.stds)), prop_ubs=0.10)
    c, t = c.cpu().numpy(), t.cpu().numpy()
    _new_ubs_respect_the_rules(dataset, c, t)
    lens = dataset[2]
    n_ub = (t > 4).sum(1)
    assert ((n_ub >= np.maximum(1, (0.05 * lens).astype(int)))
            & (n_ub <= (0.15 * lens).astype(int) + 2)).all()
    assert np.isfinite(c).all() and np.abs(c).max() < 20


def test_stitch_properties_on_card(cuda, tables, dataset):
    tbl = tables[8]
    fb = torch.from_numpy(stitch.build_relax_fallback(tbl.counts)).long()
    c, t, s = stitch.stitch_batch(
        torch.Generator(device=cuda).manual_seed(1), *_on(cuda, dataset),
        *_on(cuda, (tbl.signals, tbl.lens, tbl.counts)), prop_ubs=0.10,
        tbl_fallback=fb.to(cuda))
    assert s.all()
    _new_ubs_respect_the_rules(dataset, c.cpu().numpy(), t.cpu().numpy())


def test_closures_on_card(cuda, tables, dataset, tmp_path):
    save_ctc_data(str(tmp_path), *simulate_donor_dataset(40))
    augs = [stitch.make_stitch_augment(str(tmp_path), relax=True),
            spike.make_spike_augment(prop_ubs=0.05)]
    rng = np.random.default_rng(0)
    chunks, refs, lens, bkps = dataset
    for aug in augs:
        c, t = aug(chunks, refs, lens, bkps, rng)
        assert c.dtype == np.float32 and t.dtype == np.int32
        assert c.shape == chunks.shape and (t > 4).sum() > 0
