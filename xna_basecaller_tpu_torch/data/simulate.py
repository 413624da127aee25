"""Copied from ``xna_basecaller_tpu/data/simulate.py``;
only the package imports differ, and two functions are the port's own:
``simulate_donor_dataset``, the stitch donors that the JAX package's tests
build inline (``tests/test_stitch.py:43-67``), and ``self_reference``, the
templates that the bootstrap-data phase's tests and ``chip_smoke.py`` make
from a model's own calls.

Synthetic nanopore read/chunk simulation from the k-mer pore model.

Used for tests, benchmarks, and fully-synthetic training data — the same
squiggle generation scheme as the reference's `fully_synth` spike mode
(reference: ub-bonito/bonito/spike_chunks.py:54-134, 217-245): per-base dwell
repetitions of k-mer level means plus within-event std sampling, med/MAD
normalised.  Also produces the ctc-data artifact tuple
(chunks, references, reference_lengths, breakpoints) so the whole training
pipeline can run without real fast5 data.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

from xna_basecaller_tpu_torch.core.alphabet import (
    BASES, decode, reverse_complement_str,
)
from xna_basecaller_tpu_torch.data.pore_model import PoreModel, load_pore_model

MAD_FACTOR = 1.4826


def med_mad(x, factor: float = MAD_FACTOR):
    med = np.median(x)
    mad = np.median(np.abs(x - med)) * factor + np.finfo(np.float32).eps
    return med, mad


def random_sequence(rng, length: int, ub_prop: float = 0.0,
                    ubs: str = "XY") -> np.ndarray:
    """Random base codes [length] in 1..4, with optional UBs spiked at
    isolated positions (away from edges and each other)."""
    seq = rng.integers(1, 5, size=length)
    if ub_prop > 0:
        n_ub = max(1, round(length * ub_prop))
        pos = []
        mask = np.ones(length, bool)
        mask[:10] = mask[-10:] = False
        for _ in range(n_ub):
            valid = np.where(mask)[0]
            if not len(valid):
                break
            p = int(rng.choice(valid))
            mask[max(0, p - 5):p + 6] = False
            pos.append(p)
        codes = [5 + int(rng.integers(len(ubs))) if len(ubs) > 1 else 5
                 for _ in pos]
        seq[np.array(pos, dtype=int)] = codes
    return seq.astype(np.uint8)


# Signal regimes: "default" is the regime augmentation trains against;
# "heldout" changes the dwell distribution (gamma instead of normal, longer
# events), the within-event noise model (gaussian instead of uniform) and
# the noise floor — an out-of-distribution evaluation regime so reported
# accuracies are not circular with the training simulator (VERDICT
# round-1 item #5).
REGIMES = {
    "default": dict(samples_per_base=9.0, dwell_std=2.0, noise_std=0.5,
                    dwell_dist="normal", event_noise="uniform"),
    "heldout": dict(samples_per_base=10.5, dwell_std=3.5, noise_std=0.65,
                    dwell_dist="gamma", event_noise="gauss"),
}


def simulate_squiggle(seq_codes: np.ndarray, pore: PoreModel, rng,
                      samples_per_base: float = 9.0,
                      dwell_std: float = 2.0, noise_std: float = 0.5,
                      dwell_dist: str = "normal",
                      event_noise: str = "uniform"):
    """Base codes -> (normalised signal, breakpoints).

    breakpoints[i] = cumulative signal index at which base i's event ends
    (the reference's breakpoints.npy contract, dtw_segmentation.py:195-202).
    """
    seq = decode(seq_codes, BASES, drop_blank=False)
    means, stds = pore.seq_levels(seq, append=True)
    L = len(seq_codes)
    if dwell_dist == "gamma":
        shape = (samples_per_base / dwell_std) ** 2
        scale = dwell_std ** 2 / samples_per_base
        draws = rng.gamma(shape, scale, L)
    elif dwell_dist == "lognormal":
        # mean samples_per_base, std dwell_std (moment-matched)
        s2 = np.log1p((dwell_std / samples_per_base) ** 2)
        mu = np.log(samples_per_base) - s2 / 2
        draws = rng.lognormal(mu, np.sqrt(s2), L)
    else:
        draws = rng.normal(samples_per_base, dwell_std, L)
    reps = np.maximum(1, draws.round().astype(int))
    event_means = np.repeat(means[:L], reps)
    event_stds = np.repeat(stds[:L], reps)
    if event_noise == "gauss":
        raw = event_means + rng.normal(0, 1, event_means.shape) * event_stds
    elif event_noise == "laplace":
        # matched variance: Laplace(b) has std b*sqrt(2)
        raw = event_means + rng.laplace(
            0, 1 / np.sqrt(2), event_means.shape) * event_stds
    elif event_noise == "triangular":
        # matched variance: tri(-sqrt(6), 0, sqrt(6)) has unit std
        raw = event_means + rng.triangular(
            -np.sqrt(6), 0, np.sqrt(6), event_means.shape) * event_stds
    else:
        raw = event_means + rng.uniform(-event_stds, event_stds)
    if noise_std > 0:
        raw = raw + rng.normal(0, noise_std, raw.shape)
    med, mad = med_mad(raw)
    signal = ((raw - med) / mad).astype(np.float32)
    breakpoints = np.cumsum(reps).astype(np.uint16)
    return signal, breakpoints


@dataclass
class SimReadObj:
    read_id: str
    signal: np.ndarray
    sequence: str = ""


def simulate_reads(n_reads: int, mean_len: int = 20000, seed: int = 0,
                   ub_prop: float = 0.0, pore: PoreModel | None = None):
    """Generate reads with realistic length spread for pipeline tests/bench."""
    pore = pore or load_pore_model()
    rng = np.random.default_rng(seed)
    for i in range(n_reads):
        sig_len = int(rng.uniform(0.5, 1.5) * mean_len)
        n_bases = max(20, int(sig_len / 9.0))
        codes = random_sequence(rng, n_bases, ub_prop=ub_prop)
        signal, _ = simulate_squiggle(codes, pore, rng)
        yield SimReadObj(
            read_id=f"sim_{seed}_{i}", signal=signal,
            sequence=decode(codes, BASES, drop_blank=False))


# Structural (dwell distribution, event noise) families sampled by
# jitter_regime.  The held-out regime's (gamma, gauss) pair is EXCLUDED —
# training sees structural *variety*, never the evaluation family itself,
# so held-out numbers stay out-of-distribution.
_JITTER_FAMILIES = [
    ("normal", "uniform"),
    ("normal", "laplace"),
    ("lognormal", "uniform"),
    ("lognormal", "triangular"),
]


def jitter_regime(kw: dict, rng) -> dict:
    """Domain-randomise a signal regime (translocation rate, dwell and
    noise spreads, plus a structural dwell/noise family draw) — used for
    *training*-side reads only so the spliced model generalises beyond
    one fixed simulator setting; held-out eval regimes stay untouched.

    The scalar ranges are wide enough that realistic condition drift
    (incl. the held-out eval regime's rate/dwell/noise VALUES) falls
    inside the trained hull, while the held-out structural family pair
    (gamma dwell + gauss event noise) is still never sampled — the eval
    regime remains an unseen configuration, so the de-circularisation
    contract of the north-star eval holds."""
    dwell_dist, event_noise = _JITTER_FAMILIES[
        int(rng.integers(len(_JITTER_FAMILIES)))]
    return dict(
        kw,
        samples_per_base=kw["samples_per_base"] * float(rng.uniform(0.8, 1.3)),
        dwell_std=kw["dwell_std"] * float(rng.uniform(0.6, 2.0)),
        noise_std=kw["noise_std"] * float(rng.uniform(0.6, 1.6)),
        dwell_dist=dwell_dist, event_noise=event_noise)


def sim_library_reads(refs, rng, n_reads: int, with_ubs: bool,
                      regime: str = "default", read_len_chunks: int = 2,
                      jitter: bool = False, center_ub: bool | None = None,
                      chunk_len: int = 3600,
                      pore: PoreModel | None = None):
    """Simulated library reads: FRAGMENTS of the full-length vector
    construct, like real nanopore reads of library molecules.

    Reads are contiguous substrings of ``refs.full_targets[tid]`` (~2.7 kb
    construct, reference xna_libs/CPLX/refdb.fasta) with the UB kept as
    X/Y (with_ubs) or pc-ified to A.  Because the read is a single pass
    over construct sequence, every basecalled 3600-sample chunk aligns to
    the construct with near-full coverage — the property the reference's
    CTC-data builder gates on (io.py:505, cov >= 0.90) and the one that
    makes stored targets cover the whole chunk signal.

    center_ub (default: with_ubs) places the UB uniformly inside the
    fragment so insert-covering chunks are produced at a useful rate;
    DNA reads sample the construct uniformly.
    """
    from xna_basecaller_tpu_torch.core.alphabet import (
        encode, reverse_complement_str)

    pore = pore or load_pore_model()
    base_kw = REGIMES[regime]
    if center_ub is None:
        center_ub = with_ubs
    full = refs.full_targets
    tids = refs.xna_targets_id
    for i in range(n_reads):
        kw = jitter_regime(base_kw, rng) if jitter else base_kw
        tid = tids[int(rng.integers(len(tids)))]
        construct = full[tid]
        construct = (construct.replace("N", "X") if with_ubs
                     else construct.replace("N", "A"))
        strand = "+" if rng.random() < 0.5 else "-"
        if strand == "-":
            construct = reverse_complement_str(construct)
        frag = int(read_len_chunks * chunk_len * 1.25
                   / kw["samples_per_base"])
        frag = min(frag, len(construct))
        if center_ub and with_ubs:
            ub_char = "X" if strand == "+" else "Y"
            ubp = construct.index(ub_char)
            start = ubp - int(rng.uniform(0.15, 0.85) * frag)
            start = max(0, min(start, len(construct) - frag))
        else:
            start = int(rng.integers(0, len(construct) - frag + 1))
        seq = construct[start:start + frag]
        codes = encode(seq)
        sig, _ = simulate_squiggle(codes, pore, rng, **kw)
        yield SimReadObj(read_id=f"{tid}_{i}", signal=sig, sequence=seq)


def simulate_ctc_dataset(n_chunks: int, chunk_len: int = 3600,
                         target_len: int = 400, seed: int = 0,
                         ub_prop: float = 0.0,
                         pore: PoreModel | None = None):
    """Build an in-memory ctc-data artifact set shaped like the reference's
    chunks.npy / references.npy / reference_lengths.npy / breakpoints.npy
    (contract per SURVEY §2.5; reference data.py:129-163)."""
    pore = pore or load_pore_model()
    rng = np.random.default_rng(seed)
    chunks = np.zeros((n_chunks, chunk_len), np.float16)
    max_len = target_len + 50
    refs = np.zeros((n_chunks, max_len), np.uint8)
    lens = np.zeros(n_chunks, np.uint16)
    bkps = np.zeros((n_chunks, max_len), np.uint16)
    for i in range(n_chunks):
        # enough bases to cover the chunk at ~9 samples/base
        codes = random_sequence(rng, target_len, ub_prop=ub_prop)
        signal, bk = simulate_squiggle(codes, pore, rng)
        # trim to the last whole base that fits in chunk_len
        n_fit = int(np.searchsorted(bk, chunk_len, side="right"))
        n_fit = min(n_fit, target_len)
        sig = signal[: chunk_len]
        chunks[i, : len(sig)] = sig.astype(np.float16)
        refs[i, :n_fit] = codes[:n_fit]
        lens[i] = n_fit
        bkps[i, :n_fit] = np.minimum(bk[:n_fit], chunk_len)
    return chunks, refs, lens, bkps


# Period-6 base pattern: a target tiled with it mirrors its 5-base context
# around every position (target[p+1+j] == target[p-5+j]), the XNA1024
# library property the stitch per_kmer lookup relies on.
MIRROR_HEX = np.array([1, 2, 3, 4, 2, 3], np.uint8)


def simulate_donor_dataset(n_reads: int, chunk_len: int = 1200,
                           seed: int = 0, pore: PoreModel | None = None):
    """Single-UB ctc-data shaped like the XNA library, as stitch donors:
    read i is 20 random bases, a 5-base context, one UB (X for reads
    0-5, Y for 6-11, X again ...), the same context, 20 random bases; the
    context is the five bases of ``MIRROR_HEX`` after residue i % 6.
    Returns (chunks, references, reference_lengths, breakpoints) as
    ``simulate_ctc_dataset`` does."""
    pore = pore or load_pore_model()
    rng = np.random.default_rng(seed)
    max_len = 80
    chunks = np.zeros((n_reads, chunk_len), np.float16)
    refs = np.zeros((n_reads, max_len), np.uint8)
    lens = np.zeros(n_reads, np.uint16)
    bkps = np.zeros((n_reads, max_len), np.uint16)
    for i in range(n_reads):
        ub = 5 if (i // 6) % 2 == 0 else 6
        ctx = MIRROR_HEX[(i % 6 + 1 + np.arange(5)) % 6]
        pre = rng.integers(1, 5, size=20).astype(np.uint8)
        post = rng.integers(1, 5, size=20).astype(np.uint8)
        target = np.concatenate([pre, ctx, [ub], ctx, post]).astype(np.uint8)
        signal, bk = simulate_squiggle(target, pore, rng)
        n = len(target)
        chunks[i, : min(len(signal), chunk_len)] = \
            signal[:chunk_len].astype(np.float16)
        refs[i, :n] = target
        lens[i] = n
        bkps[i, :n] = np.minimum(bk[:n], chunk_len)
    return chunks, refs, lens, bkps


def self_reference(calls, path, min_len: int = 8,
                   reverse_first: bool = False) -> int:
    """A reference made from a model's own calls, for random weights that
    align to no real library: a template ``tpl<i>`` per distinct call of
    at least ``min_len`` bases (8: the aligner's min_score of 30 needs 7
    matches), the most frequent first, equal to the call with its X/Y as A
    and its middle base as N (the template's one UB), every other one
    reverse-complemented (the first with ``reverse_first``).  Each
    such call aligns to its own template, on '+' or '-', at the share of
    its bases that are not X/Y (a read's X/Y matches no template base), so
    a kept chunk's target holds 5 on '+' and 6 on '-'.  (A call repeated
    with a template on each strand would tie, and the aligner takes '+';
    so may a call held inside another call's template.)  Writes the FASTA
    to ``path``; returns the number of templates."""
    n = 0
    distinct = [s for s, _ in Counter(
        s for s in calls if len(s) >= min_len).most_common()]
    with open(path, "w") as fh:
        for i, seq in enumerate(distinct):
            t = seq.replace("X", "A").replace("Y", "A")
            t = t[:len(t) // 2] + "N" + t[len(t) // 2 + 1:]
            if i % 2 != reverse_first:
                t = reverse_complement_str(t)
            fh.write(f">tpl{i}\n{t}\n")
            n += 1
    return n
