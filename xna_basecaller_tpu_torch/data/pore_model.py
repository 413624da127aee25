"""Copied from ``xna_basecaller_tpu/data/pore_model.py``;
only the package imports differ.

k-mer pore model: per-k-mer signal level mean/stdv tables.

Loads the TSV pore model (16384 rows: natural 6-mers + X/Y context k-mers;
format per reference ub-bonito/bonito/spike_chunks.py:12-18) into dense
arrays indexed by base-(n_base) k-mer code, so augmentation and simulation
can run as device-side gathers instead of dict lookups.
"""

from __future__ import annotations

import os

import numpy as np

from xna_basecaller_tpu_torch.core.alphabet import BASES, encode

DEFAULT_MODEL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "r9.4_450bps.nucleotide.6mer.XNA-Px_Ds.template.model")

# Fallback level for k-mers absent from the table (e.g. multi-UB contexts);
# value matches the reference's short-sequence default level
# (spike_chunks.py:34-35).
FALLBACK_MEAN = 90.2083
FALLBACK_STD = 2.0


class PoreModel:
    """Dense pore model over the 6-base alphabet (A,C,G,T,X,Y -> 0..5).

    ``means``/``stds`` are [n_base**k] float32 arrays indexed by the k-mer
    code sum(base_i * n_base**(k-1-i)); unseen k-mers hold the fallback
    level.  ``known`` marks table-backed entries.
    """

    def __init__(self, path: str | None = None, k: int = 6):
        path = path or DEFAULT_MODEL
        self.k = k
        self.n_base = len(BASES) - 1  # 6 real bases
        size = self.n_base ** k
        self.means = np.full(size, FALLBACK_MEAN, dtype=np.float32)
        self.stds = np.full(size, FALLBACK_STD, dtype=np.float32)
        self.known = np.zeros(size, dtype=bool)
        self.table: dict[str, tuple[float, float]] = {}
        with open(path) as fh:
            header = None
            for line in fh:
                if line.startswith("#"):
                    continue
                parts = line.rstrip("\n").split("\t")
                if header is None:
                    header = parts
                    i_k = header.index("kmer")
                    i_m = header.index("level_mean")
                    i_s = header.index("level_stdv")
                    continue
                kmer = parts[i_k]
                mean, std = float(parts[i_m]), float(parts[i_s])
                self.table[kmer] = (mean, std)
                code = self.kmer_code(kmer)
                self.means[code] = mean
                self.stds[code] = std
                self.known[code] = True

    def kmer_code(self, kmer: str) -> int:
        # base codes 1..6 -> 0..5 for dense indexing
        codes = encode(kmer) - 1
        out = 0
        for c in codes:
            out = out * self.n_base + int(c)
        return out

    def lookup(self, kmer: str) -> tuple[float, float]:
        return self.table.get(kmer, (FALLBACK_MEAN, FALLBACK_STD))

    def seq_levels(self, seq: str, append: bool = True):
        """Per-position k-mer level means/stds for a sequence.

        Mirrors reference get_kmers_model (spike_chunks.py:21-42): appends an
        AT tail so every base has a k-mer, and uses the fallback level for
        sequences shorter than k.
        """
        if append:
            seq = seq + ("ATATA" if seq[-1] != "A" else "TATAT")
        L = len(seq)
        if L < self.k:
            return (np.full(L, FALLBACK_MEAN, np.float32),
                    np.full(L, FALLBACK_STD, np.float32))
        n = L - self.k + 1
        means = np.empty(n, np.float32)
        stds = np.empty(n, np.float32)
        for i in range(n):
            means[i], stds[i] = self.lookup(seq[i:i + self.k])
        return means, stds


_cached: dict[str, PoreModel] = {}


def load_pore_model(path: str | None = None) -> PoreModel:
    key = path or DEFAULT_MODEL
    if key not in _cached:
        _cached[key] = PoreModel(path)
    return _cached[key]
