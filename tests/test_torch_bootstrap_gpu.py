"""The bootstrap-data phase (``cli/basecaller.py::call_reads`` with
``--reference --save-ctc --ub-only --sam``) on the card against the CPU.
Marked ``gpu``; the test skips where there is no CUDA device.

Run it on a machine with the card:
    python -m pytest tests/test_torch_bootstrap_gpu.py -m gpu --noconftest

The CPU run decodes the card's own f32 scores with the plain decode, so
what may differ is only the decode: the card's K2b picks another
backpointer than the plain version on f32 near-ties (5-7e-6 of them at
the flagship's shapes).  Both runs record each batch's scores and labels;
the scores must be equal bit for bit.  A chunk-read whose labels differ
is counted and reported, and is allowed only where it is such a tie: the
score of the card's path and that of the plain path, both summed over
the plain K2b's Viterbi edge scores, agree within max(1e-4, 1e-6 T^2),
the tolerance of ``test_decode_kernels_match_plain_at_the_ring_edges``
for v_final (a path through a wrong edge loses units).  Every SAM record
of a chunk-read whose labels agree must be equal, and with no labels
differing the ctc-data must be equal byte for byte.
"""

import io
import os
import types

import numpy as np
import pytest
import torch

from xna_basecaller_tpu_torch.cli.basecaller import argparser, call_reads
from xna_basecaller_tpu_torch.core.config import (
    BasecallerConfig, EncoderConfig, ModelConfig,
)
from xna_basecaller_tpu_torch.data.fast5 import read_chunks
from xna_basecaller_tpu_torch.data.simulate import (
    self_reference, simulate_reads,
)
from xna_basecaller_tpu_torch.infer import basecall as tb
from xna_basecaller_tpu_torch.models.crf_model import Model
from xna_basecaller_tpu_torch.ops import crf, crf_cuda

pytestmark = pytest.mark.gpu


class _CardScoresDecodedOnCPU:
    """The card's model, whose scores come back to the CPU, so that the
    pipeline decodes them with the plain decode."""

    def __init__(self, model):
        self.model, self.stride, self.seqdist = (model, model.stride,
                                                 model.seqdist)

    def parameters(self):
        return iter([torch.zeros(1)])

    def __call__(self, x, **kw):
        return self.model(x.cuda(), **kw).cpu()


def _viterbi_edges(s, n_base, state_len):
    """The plain K2b's Viterbi edge scores of scores ``s`` [T, N, C] (CPU,
    f32): log(exp(alpha[pred] + score + beta_{t+1} - logZ) + 1e-8) as
    [T, N, n_state, n_base + 1], column 0 the stay."""
    Ms, ns = crf._split(s, n_base, state_len)
    betas = crf.backward_scores(s, n_base, state_len)
    logz = crf.logz_from_betas(betas)
    alpha = s.new_zeros(s.shape[1], ns)
    edges = []
    for t, ms_t in enumerate(Ms):
        pred_a = crf._expand_pred(alpha, n_base, ns)
        edge = torch.cat([alpha[..., None], pred_a], -1) + ms_t \
            + betas[t + 1][..., None] - logz[:, None, None]
        edges.append(torch.log(torch.exp(edge) + 1e-8))
        alpha = crf._lse(torch.cat([(alpha + ms_t[..., 0])[..., None],
                                    pred_a + ms_t[..., 1:]], -1), -1)
    return torch.stack(edges)


def _path_score(edges, bp, v_final, n_base):
    """The sum of ``edges`` [T, n_state, n_base + 1] along the path that
    K2c's traceback takes through ``bp`` [T, n_state] from the first
    maximum of ``v_final``, in float64."""
    nsd = bp.shape[-1] // n_base
    j, total = int(v_final.argmax()), 0.0
    for t in range(bp.shape[0] - 1, -1, -1):
        k = int(bp[t, j])
        total += float(edges[t, j, k])
        if k:
            j = (k - 1) * nsd + j // n_base
    return total


def _record_decodes(monkeypatch):
    """Record every batch's decode input and labels."""
    seen, decode = [], tb._score_and_decode

    def recording(scores, n_base, state_len, reverse=False, ub_bias=0.0,
                  alphabet=None):
        labels = decode(scores, n_base, state_len, reverse, ub_bias,
                        alphabet)
        seen.append((scores.float().cpu(), reverse, ub_bias, labels.cpu(),
                     alphabet))
        return labels

    monkeypatch.setattr(tb, "_score_and_decode", recording)
    return seen


def _ties(card, cpu, n_base, state_len, ties, cuda) -> int:
    """One batch's decodes on the card and on the CPU (scores, reverse,
    ub_bias, labels, alphabet): the scores equal, and each row whose labels differ a
    tie of its two paths (appended to ``ties``).  Returns the rows that
    differ."""
    assert torch.equal(card[0], cpu[0])
    rows = (card[3] != cpu[3]).any(-1).nonzero().flatten().tolist()
    if not rows:
        return 0
    s = tb._apply_ub_bias(crf.reverse_complement(
        card[0], n_base, state_len, card[4]) if card[1] else card[0],
        n_base, card[2])
    sc = crf_cuda._ring_aligned(s.to(cuda).contiguous())
    betas = crf_cuda.backward_scan(sc, n_base, state_len)
    bp_c, v_c = crf_cuda.forward_viterbi(
        sc, betas, crf.logz_from_betas(betas), n_base, state_len)
    assert torch.equal(crf_cuda.viterbi_traceback(
        bp_c, v_c, n_base, state_len).cpu(), card[3])
    betas_p = crf.backward_scores(s, n_base, state_len)
    bp_p, v_p = crf.forward_viterbi(
        s, betas_p, crf.logz_from_betas(betas_p), n_base, state_len)
    assert torch.equal(crf.viterbi_traceback(
        bp_p, v_p, n_base, state_len), cpu[3])
    edges = _viterbi_edges(s, n_base, state_len)
    T = s.shape[0]
    for n in rows:
        got = _path_score(edges[:, n], bp_c[:, n].cpu(), v_c[n].cpu(),
                          n_base)
        want = _path_score(edges[:, n], bp_p[:, n], v_p[n], n_base)
        ties.append(abs(got - want))
        assert abs(got - want) <= max(1e-4, 1e-6 * T * T), (n, got,
                                                            want)
    return len(rows)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_call_reads_save_ctc_card_vs_cpu(cuda, tmp_path, monkeypatch):
    plain = tb.basecall
    monkeypatch.setattr(tb, "basecall", lambda *a, **kw: plain(
        *a, compute_dtype=torch.float32, **kw))
    cfg = ModelConfig(encoder=EncoderConfig(features=64, num_rnn_layers=2),
                      basecaller=BasecallerConfig(batchsize=16,
                                                  chunksize=1200,
                                                  overlap=200))
    model = Model(cfg, device=cuda, seed=0).eval()
    reads = [types.SimpleNamespace(
        read_id=r.read_id, signal=r.signal, run_id="", filename="", mux=0,
        channel=0, start=0.0, duration=0.0)
        for r in simulate_reads(6, mean_len=8000, seed=1)]

    def run(m, reads, *flags):
        out = io.StringIO()
        args = argparser().parse_args(["model", "reads", *flags])
        stats = call_reads(args, m, cfg, iter(reads), out=out)
        return stats, out.getvalue()

    # the chunk-reads' calls (FASTQ), for the self-reference; random
    # weights call X/Y on many frames, which no template base matches: the
    # runs take the --ub-bias whose calls hold the most canonical bases
    chunk_reads = [c for r in reads for c in read_chunks(r, 1200, 200)]
    ladder = []
    for bias in ("0", "-1", "-2", "-4"):
        calls = run(model, chunk_reads, "--ub-bias", bias)[1].split(
            "\n")[1::4]
        ladder.append((sum(len(c) - c.count("X") - c.count("Y")
                           for c in calls), bias, calls))
    _, bias, calls = max(ladder)
    fasta = tmp_path / "ref.fasta"
    n = self_reference(calls, fasta)
    print(f"--ub-bias {bias}: calls {len(calls)}, lengths "
          f"{sorted(map(len, calls))}, templates {n}")
    assert n > 0
    flags = ["--reference", str(fasta), "--ub-only", "--sam", "--ub-bias",
             bias, "--ctc-min-accuracy", "0.2", "--ctc-min-coverage", "0.5"]
    out, decodes = {}, {}
    for name, m in (("card", model), ("cpu", _CardScoresDecodedOnCPU(model))):
        with monkeypatch.context() as mp:
            decodes[name] = _record_decodes(mp)
            out[name] = run(m, reads, *flags, "--save-ctc",
                            str(tmp_path / name))
    (s_card, sam_card), (s_cpu, sam_cpu) = out["card"], out["cpu"]
    assert s_card["reads"] == s_cpu["reads"] > 0

    # the chunk-reads whose labels differ, each a tie of its two paths
    n_base, state_len = model.seqdist.n_base, model.seqdist.state_len
    ties, differ_rows = [], 0
    assert len(decodes["card"]) == len(decodes["cpu"]) > 0
    for card, cpu in zip(decodes["card"], decodes["cpu"]):
        with torch.inference_mode():
            differ_rows += _ties(card, cpu, n_base, state_len, ties, cuda)
    rec_card = [l.split("\t") for l in sam_card.splitlines()
                if not l.startswith("@")]
    rec_cpu = [l.split("\t") for l in sam_cpu.splitlines()
               if not l.startswith("@")]
    by_id = {r[0]: r for r in rec_cpu}
    differ = [r[0] for r in rec_card if by_id.get(r[0], [None] * 10)[9]
              != r[9]]
    print(f"chunk-reads whose labels differ, card vs CPU: {differ_rows} of "
          f"{s_card['reads']} (calls {len(differ)}), each a near-tie: "
          f"path scores within {max(ties, default=0.0):.3e}")
    assert len(differ) <= differ_rows
    if not differ_rows:
        assert rec_card == rec_cpu
    for r in rec_card:
        if r[0] not in differ:
            assert r == by_id[r[0]]
    flags_seen = {r[1] for r in rec_card}
    assert {"0", "16"} <= flags_seen, flags_seen
    files = sorted(os.listdir(tmp_path / "card"))
    assert "chunks.npy" in files
    refs = np.load(tmp_path / "card" / "references.npy")
    assert (refs == 5).any() and (refs == 6).any()
    if not differ_rows:
        for f in files:
            assert (tmp_path / "card" / f).read_bytes() \
                == (tmp_path / "cpu" / f).read_bytes(), f
