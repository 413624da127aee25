"""The port's construct aligner (``eval/construct_align.py``) against the
JAX package's on chunk-length pieces of simulated CPLX library reads
(``sim_library_reads``, both strands, with and without UBs, with
sequencing errors): every record (``as_dict()``) and its ``refseq`` equal,
through the native banded SW and demux and through the pure-Python
fallbacks; ``DiagIndex`` and ``query_span_for_ref_window`` equal."""

import numpy as np
import pytest

from xna_basecaller_tpu.eval import construct_align as jca
from xna_basecaller_tpu.eval.xna_refs import XnaRefs as JXnaRefs
from xna_basecaller_tpu_torch.data.simulate import sim_library_reads
from xna_basecaller_tpu_torch.eval import construct_align as ca
from xna_basecaller_tpu_torch.eval.xna_refs import XnaRefs


@pytest.fixture(scope="module")
def aligners():
    return {ubs: (ca.from_refs(XnaRefs("CPLX"), with_ubs=ubs),
                  jca.from_refs(JXnaRefs("CPLX"), with_ubs=ubs))
            for ubs in (True, False)}


def _pieces(with_ubs, seed, n_reads=3, piece=380):
    """Chunk-length pieces of simulated reads' sequences, with errors,
    and a junk read that aligns nowhere."""
    rng = np.random.default_rng(seed)
    out = []
    for read in sim_library_reads(XnaRefs("CPLX"), rng, n_reads, with_ubs,
                                  read_len_chunks=2):
        seq = read.sequence
        for j in range(0, len(seq) - piece // 2, piece):
            s = []
            for ch in seq[j:j + piece]:
                r = rng.random()
                if r < 0.02:
                    continue
                if r < 0.05:
                    ch = "ACGT"[rng.integers(4)]
                s.append(ch)
            out.append((f"{read.read_id}:{j}", "".join(s)))
    out.append(("junk", "".join("ACGT"[i] for i in rng.integers(0, 4, 300))))
    return out


def _check(aligner, jaligner, pieces):
    n_mapped = 0
    for rid, seq in pieces:
        got, want = aligner.align(rid, seq), jaligner.align(rid, seq)
        assert (got is None) == (want is None), rid
        if want is None:
            continue
        n_mapped += 1
        assert got.as_dict() == want.as_dict()
        assert aligner.refseq(got) == jaligner.refseq(want)
    return n_mapped


@pytest.mark.parametrize("with_ubs", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_construct_aligner_equals_jax(aligners, with_ubs, seed):
    aligner, jaligner = aligners[with_ubs]
    assert aligner.ids == jaligner.ids and aligner.canon == jaligner.canon
    assert aligner.insert_hi == jaligner.insert_hi
    pieces = _pieces(with_ubs, seed)
    assert _check(aligner, jaligner, pieces) >= len(pieces) - 2


def test_construct_aligner_without_the_native_library(aligners,
                                                      monkeypatch):
    """No native library: full-matrix SW and the per-candidate Python
    demux, in both packages, give the same records."""
    monkeypatch.setattr(ca, "sw_align_banded", lambda *a: None)
    monkeypatch.setattr(ca, "lev_demux", lambda *a: None)
    monkeypatch.setattr(jca, "sw_align_banded", lambda *a: None)
    monkeypatch.setattr(jca, "lev_demux", lambda *a: None)
    aligner, jaligner = aligners[True]
    pieces = _pieces(True, 2, n_reads=1)[:3]
    assert _check(aligner, jaligner, pieces) >= 1


def test_diag_index_and_query_span_equal_jax(aligners):
    aligner, jaligner = aligners[True]
    rng = np.random.default_rng(4)
    for _ in range(5):
        i = int(rng.integers(0, len(aligner.canon) - 400))
        q = aligner.canon[i:i + 400]
        assert aligner._diag.best_diag(q) == jaligner._diag.best_diag(q)
    cigar = [("=", 30), ("I", 2), ("=", 10), ("D", 3), ("X", 1), ("=", 40)]
    for q0, r0 in ((0, 0), (5, 100)):
        for wlo, whi in ((0, 10), (r0 + 35, r0 + 60), (r0 + 41, r0 + 44),
                         (r0 + 80, r0 + 200), (r0 - 20, r0 + 5),
                         (r0 + 500, r0 + 600)):
            assert ca.query_span_for_ref_window(cigar, q0, r0, wlo, whi) == \
                jca.query_span_for_ref_window(cigar, q0, r0, wlo, whi)
