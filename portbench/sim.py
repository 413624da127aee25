"""The benchmark's traffic: simulated nanopore reads and ctc-data chunks.

Frozen copies of the port's simulator (``data/simulate.py``:
``random_sequence``, ``simulate_squiggle``, ``simulate_ctc_dataset``;
``data/pore_model.py``), so that a change to the program cannot change
what the benchmark feeds it.  Two departures, neither of which changes a
draw: the k-mer levels are looked up with one gather over the dense table
instead of a dictionary per position, and ``random_sequence`` takes the
number of unnatural bases (X/Y) directly instead of a proportion.

Every size is fixed by the traffic file and not by the seed: a seed
shuffles the order of the reads and draws their bases and noise, so all
seeds of a cell carry the same amount of work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

BASES = "NACGTXY"
MAD_FACTOR = 1.4826
PORE_MODEL = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "assets",
    "r9.4_450bps.nucleotide.6mer.XNA-Px_Ds.template.model")
# the level of k-mers absent from the table, as the port's pore model
FALLBACK_MEAN = 90.2083
FALLBACK_STD = 2.0
KMER = 6
N_REAL = 6   # A C G T X Y


class PoreModel:
    """Dense k-mer level tables over A,C,G,T,X,Y (codes 1..6 -> 0..5)."""

    def __init__(self, path: str = PORE_MODEL):
        size = N_REAL ** KMER
        self.means = np.full(size, FALLBACK_MEAN, np.float32)
        self.stds = np.full(size, FALLBACK_STD, np.float32)
        lut = np.full(256, -1, np.int64)
        for i, c in enumerate(BASES[1:]):
            lut[ord(c)] = i
        kmers, means, stds = [], [], []
        with open(path) as fh:
            header = next(fh).rstrip("\n").split("\t")
            i_k, i_m, i_s = (header.index(k) for k in
                             ("kmer", "level_mean", "level_stdv"))
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                kmers.append(parts[i_k])
                means.append(float(parts[i_m]))
                stds.append(float(parts[i_s]))
        codes = lut[np.frombuffer("".join(kmers).encode(), np.uint8)]
        codes = codes.reshape(-1, KMER) @ (N_REAL ** np.arange(KMER - 1, -1,
                                                              -1))
        self.means[codes] = means
        self.stds[codes] = stds

    def seq_levels(self, codes: np.ndarray):
        """Per-base level means and stds of base codes 1..6, with the AT
        tail appended so that every base has a k-mer
        (``PoreModel.seq_levels``)."""
        tail = [1, 4, 1, 4, 1] if codes[-1] != 1 else [4, 1, 4, 1, 4]
        seq = np.concatenate([codes, tail]).astype(np.int64) - 1
        if len(seq) < KMER:
            return (np.full(len(seq), FALLBACK_MEAN, np.float32),
                    np.full(len(seq), FALLBACK_STD, np.float32))
        win = np.lib.stride_tricks.sliding_window_view(seq, KMER)
        idx = win @ (N_REAL ** np.arange(KMER - 1, -1, -1))
        return self.means[idx], self.stds[idx]


def random_sequence(rng, length: int, n_ub: int = 0,
                    ubs: str = "XY") -> np.ndarray:
    """Random base codes in 1..4 with ``n_ub`` X/Y at isolated positions,
    away from the ends and from each other (``random_sequence``)."""
    seq = rng.integers(1, 5, size=length)
    if n_ub > 0:
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


def simulate_squiggle(codes: np.ndarray, pore: PoreModel, rng,
                      samples_per_base: float = 9.0, dwell_std: float = 2.0,
                      noise_std: float = 0.5):
    """Base codes -> (med/MAD-normalised signal f32, breakpoints): normal
    dwells, uniform within-event noise, gaussian noise floor (the default
    regime of ``simulate_squiggle``)."""
    means, stds = pore.seq_levels(codes)
    L = len(codes)
    reps = np.maximum(1, rng.normal(samples_per_base, dwell_std, L)
                      .round().astype(int))
    event_means = np.repeat(means[:L], reps)
    event_stds = np.repeat(stds[:L], reps)
    raw = event_means + rng.uniform(-event_stds, event_stds)
    if noise_std > 0:
        raw = raw + rng.normal(0, noise_std, raw.shape)
    med = np.median(raw)
    mad = np.median(np.abs(raw - med)) * MAD_FACTOR \
        + np.finfo(np.float32).eps
    return ((raw - med) / mad).astype(np.float32), \
        np.cumsum(reps).astype(np.uint16)


def read_lengths(spec: dict) -> np.ndarray:
    """The pool's read lengths in samples, one per read: the quantiles
    (i + 0.5) / n of the traffic's length distribution, so that every seed
    gets the same set of sizes."""
    n = int(spec["pool_reads"])
    q = (np.arange(n) + 0.5) / n
    dist = spec["length"]
    if dist["dist"] == "uniform":
        lengths = dist["low"] + (dist["high"] - dist["low"]) * q
    elif dist["dist"] == "lognormal":
        from statistics import NormalDist
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
        lengths = np.clip(dist["median"] * np.exp(dist["sigma"] * z),
                          dist["low"], dist["high"])
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return lengths.astype(np.int64)


@dataclass
class Read:
    """A read as the port's pipeline takes it."""
    read_id: str
    signal: np.ndarray
    pool_index: int


def read_pool(spec: dict, seed: int, pore: PoreModel | None = None):
    """The cell's pool of reads: for each length of ``read_lengths``, in an
    order drawn from ``seed``, a random sequence with the traffic's X/Y
    count, simulated and cut to exactly that many samples."""
    pore = pore or PoreModel()
    rng = np.random.default_rng(seed)
    lengths = read_lengths(spec)
    rng.shuffle(lengths)
    spb = float(spec.get("samples_per_base", 9.0))
    pool = []
    for length in lengths:
        # 10 % more bases than the length needs, then cut to the length
        n_bases = int(length / spb * 1.1) + 20
        codes = random_sequence(rng, n_bases, n_ub=int(spec["ub_per_read"]))
        sig, _ = simulate_squiggle(codes, pore, rng, samples_per_base=spb)
        if len(sig) < length:
            raise RuntimeError("simulated read shorter than its length")
        pool.append(sig[:length])
    return pool


def replay(pool, seed: int, cancel=None, on_pull=None):
    """Reads from ``pool`` without end, each pass in a new order drawn from
    ``seed``, each under a fresh id ``r<k>``.  ``on_pull(k, time)`` is
    called as the consumer takes read k; ``cancel`` (an Event) ends it."""
    from time import perf_counter
    rng = np.random.default_rng([seed, 1])
    k = 0
    while cancel is None or not cancel.is_set():
        for i in rng.permutation(len(pool)):
            if cancel is not None and cancel.is_set():
                return
            if on_pull is not None:
                on_pull(k, perf_counter())
            yield Read(f"r{k}", pool[i], int(i))
            k += 1


def ctc_dataset(spec: dict, seed: int, pore: PoreModel | None = None):
    """(chunks [n, chunksize] f16, references [n, target_len + 50] u8,
    reference_lengths [n] u16) as ``simulate_ctc_dataset`` builds them, with
    ``ub_per_target`` X/Y in every target.  ``samples_per_base`` [first,
    last] drifts linearly over the chunks, in the order they are written,
    as a pore's translocation speed drifts over a run (9 throughout when
    not given)."""
    pore = pore or PoreModel()
    rng = np.random.default_rng(seed)
    n, chunk_len = int(spec["chunks"]), int(spec["chunksize"])
    target_len = int(spec["target_len"])
    chunks = np.zeros((n, chunk_len), np.float16)
    refs = np.zeros((n, target_len + 50), np.uint8)
    lens = np.zeros(n, np.uint16)
    spb = np.linspace(*spec.get("samples_per_base", (9.0, 9.0)), n)
    for i in range(n):
        codes = random_sequence(rng, target_len,
                                n_ub=int(spec["ub_per_target"]))
        signal, bk = simulate_squiggle(codes, pore, rng,
                                       samples_per_base=float(spb[i]))
        n_fit = min(int(np.searchsorted(bk, chunk_len, side="right")),
                    target_len)
        sig = signal[:chunk_len]
        chunks[i, :len(sig)] = sig.astype(np.float16)
        refs[i, :n_fit] = codes[:n_fit]
        lens[i] = n_fit
    return chunks, refs, lens
