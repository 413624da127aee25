"""The port's duplex path, POA and the model-facing CLIs against the JAX
package, on the CPU: the native wrappers (``ctc_beam_search``,
``poa_consensus``, ``nw_trace``, ``pair_viterbi``), ``poa``, the pair
decode's host parts, ``read_transition_probs``, ``decode_pair``,
``find_follow_on`` on a summary read with ``csv`` (JAX's with pandas), the
``duplex`` CLI's FASTQ on a simulated template/complement pair, and the
output of ``evaluate`` (with ``--weights 1,2 --poa``), ``view`` and
``export``.

Tolerances: ``read_transition_probs`` in f32 from the same weights: the
posteriors atol 5e-5, and the log-posteriors of the probable transitions
(p > 1e-3) and of the initial states atol 5e-4 (each frame's posterior
adds the betas, sums over the rest of its chunk (200 frames here) whose
f32 rounding follows XLA's order in JAX and torch's here: 1.5e-4 at most
on this input); everything else exact (``evaluate``'s lines but its
host-clock times).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.cli import main as jax_cli
from xna_basecaller_tpu.core import config as jconfig
from xna_basecaller_tpu.core.config import (
    BlockConfig, EncoderConfig, ModelConfig,
)
from xna_basecaller_tpu.infer import basecall as jbasecall
from xna_basecaller_tpu.infer import duplex as jduplex
from xna_basecaller_tpu.infer import pair_decode as jpd
from xna_basecaller_tpu.models.crf_model import Model as JaxModel
from xna_basecaller_tpu.ops import crf as jcrf
from xna_basecaller_tpu.train import checkpoint as jckpt
from xna_basecaller_tpu.utils import native as jnative
from xna_basecaller_tpu.utils import poa as jpoa
from xna_basecaller_tpu_torch.cli import main as port_cli
from xna_basecaller_tpu_torch.core.alphabet import reverse_complement_str
from xna_basecaller_tpu_torch.data.ctc_data import save_ctc_data
from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
from xna_basecaller_tpu_torch.data.simulate import (
    simulate_ctc_dataset, simulate_squiggle,
)
from xna_basecaller_tpu_torch.infer import duplex as tduplex
from xna_basecaller_tpu_torch.infer import pair_decode as tpd
from xna_basecaller_tpu_torch.ops import crf as tcrf
from xna_basecaller_tpu_torch.utils import native, poa
from xna_basecaller_tpu_torch.utils.model_io import load_model

from test_torch_crf import relabel_columns, to_complement

@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: among the other test workers a pool of a thread
    per core spends its time waiting at each small op's barrier (this
    file's tests took 20-120x their time alone in the whole suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


needs_native = pytest.mark.skipif(
    not (native.available() and jnative.available()),
    reason="the native library does not build here")


def _rand_trans(rng, T, ns, nb):
    x = rng.normal(size=(T, ns, nb + 1))
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _seqs(rng, n, length, alphabet="ACGTXY"):
    base = "".join(rng.choice(list(alphabet), size=length))
    out = []
    for _ in range(n):
        s = list(base)
        for _ in range(length // 10):
            i = int(rng.integers(len(s)))
            op = rng.integers(3)
            if op == 0:
                s[i] = str(rng.choice(list(alphabet)))
            elif op == 1:
                del s[i]
            else:
                s.insert(i, str(rng.choice(list(alphabet))))
        out.append("".join(s))
    return out


@needs_native
@pytest.mark.parametrize("which", ["ctc_beam_search", "poa_consensus",
                                   "nw_trace", "pair_viterbi"])
def test_native_wrappers_match_jax(which):
    rng = np.random.default_rng(1)
    if which == "ctc_beam_search":
        x = rng.normal(size=(80, 5))
        p = (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)
        for beam in (1, 5, 16):
            got = native.ctc_beam_search(p, "NACGT", beam, 1e-3)
            want = jnative.ctc_beam_search(p, "NACGT", beam, 1e-3)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
    elif which == "poa_consensus":
        for n in (2, 3, 6):
            group = _seqs(rng, n, 60)
            assert native.poa_consensus(group) == \
                jnative.poa_consensus(group)
    elif which == "nw_trace":
        a, b = _seqs(rng, 2, 70)
        np.testing.assert_array_equal(native.nw_trace(a, b),
                                      jnative.nw_trace(a, b))
        assert native.nw_trace(a, b, max_cells=10) is None
    else:
        nb, ns = 4, 16
        t1, t2 = _rand_trans(rng, 14, ns, nb), _rand_trans(rng, 12, ns, nb)
        i1 = i2 = np.log(np.full(ns, 1.0 / ns, np.float32))
        env = np.stack([np.zeros(14, np.int64), np.full(14, 12)], 1)
        got = native.pair_viterbi(t1, i1, t2, i2, env, nb)
        want = jnative.pair_viterbi(t1, i1, t2, i2, env, nb)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_poa_matches_jax():
    rng = np.random.default_rng(2)
    groups = [_seqs(rng, n, 50) for n in (1, 2, 4)] + [["", "ACGT"], []]
    assert poa.poa(groups) == jpoa.poa(groups)
    assert poa.poa(groups, max_poa_sequences=2) == \
        jpoa.poa(groups, max_poa_sequences=2)
    for g in groups[:3]:
        assert poa._consensus_py(g) == jpoa._consensus_py(g)


def test_pair_decode_host_parts_match_jax():
    rng = np.random.default_rng(3)
    a, b = _seqs(rng, 2, 30, "ACGT")
    np.testing.assert_array_equal(tpd.nw_trace_np(a, b), jpd.nw_trace_np(a, b))
    np.testing.assert_array_equal(tpd.nw_columns(a, b), jpd.nw_columns(a, b))
    nb, ns = 4, 16
    t1, t2 = _rand_trans(rng, 20, ns, nb), _rand_trans(rng, 18, ns, nb)
    i1 = np.log(np.full(ns, 1.0 / ns, np.float32))
    c1, f1 = tpd.simplex_from_trans(t1, i1, nb)
    c2, f2 = tpd.simplex_from_trans(t2, i1, nb)
    for x, y in zip((c1, f1), jpd.simplex_from_trans(t1, i1, nb)):
        np.testing.assert_array_equal(x, y)
    aln = tpd.nw_trace_np("A" * len(c1), "A" * len(c2))
    env = tpd.build_envelope(20, f1, 18, f2, aln, padding=3)
    np.testing.assert_array_equal(
        env, jpd.build_envelope(20, f1, 18, f2, aln, padding=3))
    for x, y in zip(tpd.pair_viterbi_np(t1, i1, t2, i1, env, nb),
                    jpd.pair_viterbi_np(t1, i1, t2, i1, env, nb)):
        np.testing.assert_array_equal(x, y)


def _plant_scores(rng, true_codes, nb, sl, dwell=3, boost=9.0):
    """CRF scores [T, 1, C] with a planted path's transitions boosted (as
    tests/test_pair_decode.py plants them)."""
    ns = nb ** sl
    nsd = ns // nb
    events, s = [], 0
    for b in true_codes:
        for _ in range(int(rng.integers(1, dwell + 1))):
            events.append((s, 0))
        dropped = s // nsd
        s = (s % nsd) * nb + b
        events.append((s, 1 + dropped))
    events += [(s, 0)] * 2
    scores = rng.normal(size=(len(events), 1, ns * (nb + 1)))
    for t, (st, k) in enumerate(events):
        scores[t, 0, st * (nb + 1) + k] += boost
    return scores.astype(np.float32)


@needs_native
def test_decode_pair_matches_jax():
    """Transition posteriors of two planted strands, by each package's
    ``compute_transition_probs``; the port's decode of its own posteriors
    equals JAX's decode of JAX's, and recovers the planted sequence."""
    alphabet, sl = "NACGTXY", 2
    nb = len(alphabet) - 1
    rng = np.random.default_rng(7)
    codes = rng.integers(0, nb, size=30)
    strands_j, strands_t = [], []
    for seed in (1, 2):
        sc = _plant_scores(np.random.default_rng(seed), codes, nb, sl)
        tj, ij = jcrf.compute_transition_probs(sc, nb, sl)
        strands_j.append((np.log(np.asarray(tj)[:, 0] + 1e-30),
                          np.log(np.asarray(ij)[0] + 1e-30)))
        tt, it = tcrf.compute_transition_probs(torch.from_numpy(sc), nb, sl)
        strands_t.append((np.log(tt[:, 0].numpy() + 1e-30),
                          np.log(it[0].numpy() + 1e-30)))
    want = jpd.decode_pair(*strands_j[0], *strands_j[1], alphabet)
    got = tpd.decode_pair(*strands_t[0], *strands_t[1], alphabet)
    assert got == want
    assert got[0] == "".join(alphabet[c + 1] for c in codes)


def _planted_strand(seq: str, alphabet: str, sl: int, seed: int,
                    reverse: bool = False):
    """The log transition posteriors and log initial states of a strand
    planted with ``seq`` in its own orientation; ``reverse``: a complement
    strand, reverse-complemented into the template's orientation first, as
    ``read_transition_probs`` does."""
    nb = len(alphabet) - 1
    codes = [alphabet.index(c) - 1 for c in seq]
    sc = torch.from_numpy(_plant_scores(np.random.default_rng(seed), codes,
                                        nb, sl))
    if reverse:
        sc = tcrf.CTCCRF(sl, alphabet).reverse_complement(sc)
    tt, it = tcrf.compute_transition_probs(sc, nb, sl)
    return (np.log(tt[:, 0].numpy() + 1e-30),
            np.log(it[0].numpy() + 1e-30))


def _planted_seq(seed: int, n: int = 30, alphabet: str = "NACGTXY"):
    rng = np.random.default_rng(seed)
    return "".join(alphabet[1 + int(c)]
                   for c in rng.integers(0, len(alphabet) - 1, size=n))


@needs_native
def test_decode_pair_joins_a_planted_template_and_complement():
    """A planted NACGTXY pair: the complement strand carries the reverse
    complement of the template's sequence; reverse-complemented through
    the alphabet's map, the pair's joint call is the planted sequence.
    A planted strand starts in the all-A state, so the template's sequence
    ends in T's that the complement's start state stands for."""
    alphabet, sl = "NACGTXY", 2
    seq = _planted_seq(7) + "T" * sl
    assert set("XY") <= set(seq)
    got = tpd.decode_pair(
        *_planted_strand(seq, alphabet, sl, 1),
        *_planted_strand(reverse_complement_str(seq)[sl:], alphabet, sl, 2,
                         reverse=True), alphabet)
    assert got is not None and got[0] == seq


@needs_native
def test_decode_pair_turns_down_unrelated_strands():
    """Two unrelated planted strands: JAX's match gate (identity over a
    local alignment, no coverage floor) lets them through on a short
    alignment; the port's (it must cover half of the template's call)
    turns them down, so the caller falls back to the consensus merge."""
    from xna_basecaller_tpu.eval.accuracy import accuracy as jaccuracy

    alphabet, sl = "NACGTXY", 2
    seq1, seq2 = _planted_seq(11), _planted_seq(21)
    assert jaccuracy(seq1, seq2) >= 80.0          # 5 of 6 columns
    strands = (*_planted_strand(seq1, alphabet, sl, 1),
               *_planted_strand(seq2, alphabet, sl, 2))
    assert tpd.decode_pair(*strands, alphabet) is None
    assert jpd.decode_pair(*strands, alphabet) is not None


class _PlantedModel(torch.nn.Module):
    """Stands in for a CRF model: every chunk of a batch scores as one
    planted read (one chunk a read, chunksize = its frames, stride 1)."""

    stride = 1

    def __init__(self, scores: np.ndarray, alphabet: str, state_len: int):
        super().__init__()
        self.scores = torch.nn.Parameter(torch.from_numpy(scores),
                                         requires_grad=False)
        self.seqdist = tcrf.CTCCRF(state_len, alphabet)

    def forward(self, batch, compute_dtype=None, lstm_int8=False):
        return self.scores.expand(-1, batch.shape[0], -1)


def test_planted_xy_read_on_the_reverse_strand_is_its_reverse_complement():
    """A planted NACGTXY read of 30 bases through ``basecall``: its
    R-strand call is the reverse complement of its F-strand call, up to
    the k-mer context at either end (JAX's index flip gives a call of X/Y
    where T/A belong)."""
    from types import SimpleNamespace

    from xna_basecaller_tpu_torch.infer import basecall as tbasecall

    alphabet, sl = "NACGTXY", 2
    seq = _planted_seq(7)
    sc = _plant_scores(np.random.default_rng(3),
                       [alphabet.index(c) - 1 for c in seq], 6, sl)
    model = _PlantedModel(sc, alphabet, sl)
    read = SimpleNamespace(read_id="r",
                           signal=np.zeros(len(sc), np.float32))

    def call(reverse):
        (_, attrs), = tbasecall.basecall(
            model, iter([read]), chunksize=len(sc), overlap=0, batchsize=2,
            reverse=reverse, compute_dtype=torch.float32)
        return attrs["sequence"]

    fwd, rev = call(False), call(True)
    # F: the all-A start state's bases, then the read's but the last sl,
    # which the end state holds; R: the reverse complement of the read
    assert fwd == "A" * sl + seq[:-sl]
    assert rev == reverse_complement_str(seq)
    assert reverse_complement_str(rev)[:-sl] == fwd[sl:]
    jax_r = tcrf.CTCCRF(sl, alphabet).path_to_str(np.asarray(
        jbasecall._score_and_decode(jnp.asarray(sc), 6, sl, True))[0])
    assert jax_r != reverse_complement_str(seq)


def _crf_dir(path, seed=0):
    cfg = ModelConfig(encoder=EncoderConfig(features=32, num_rnn_layers=2))
    os.makedirs(path, exist_ok=True)
    jconfig.save(cfg, str(path))
    params = JaxModel(cfg).init(jax.random.key(seed))
    jckpt.save_checkpoint(str(path), 1, params)
    return cfg, params


@pytest.mark.parametrize("reverse", [False, True])
def test_read_transition_probs_matches_jax(tmp_path, reverse):
    cfg, params = _crf_dir(tmp_path / "m")
    sig = np.random.default_rng(5).normal(size=2700).astype(np.float32)
    opts = dict(chunksize=1000, overlap=200, reverse=reverse)
    tj, ij = jpd.read_transition_probs(JaxModel(cfg), params, sig, **opts)
    if reverse:
        # JAX's complement strand relabelled to the alphabet's complement
        # (test_torch_crf.py): states and columns, as scores are laid out
        g = to_complement(6, "NACGTXY")
        tj = relabel_columns(tj.reshape(len(tj), -1), g, 6, 3).reshape(
            tj.shape)
        ij = relabel_columns(np.repeat(ij[:, None], 7, 1).reshape(-1), g,
                             6, 3).reshape(-1, 7)[:, 0]
    model, _ = load_model(str(tmp_path / "m"), device="cpu")
    tt, it = tpd.read_transition_probs(model, sig, **opts)
    assert tt.shape == tj.shape == (540, 216, 7) and it.shape == ij.shape
    np.testing.assert_allclose(np.exp(tt), np.exp(tj), atol=5e-5)
    np.testing.assert_allclose(it, ij, atol=5e-4)
    probable = np.exp(tj) > 1e-3
    np.testing.assert_allclose(tt[probable], tj[probable], atol=5e-4)


def _summary_rows():
    base = dict(run_id="r1", alignment_coverage=0.95,
                sequence_length_template=500, duration=1.0)
    pairs = [  # (channel, dt, dir2, start2): a pair only for channel 1
        (1, 2.0, "-", 110), (2, 2.0, "+", 100), (3, 50.0, "-", 100),
        (4, 2.0, "-", 900)]
    rows = []
    for ch, dt, d2, s2 in pairs:
        rows.append(dict(base, read_id=f"t{ch}", channel=ch, mux=1,
                         start_time=10.0 * ch, alignment_direction="+",
                         alignment_genome_start=100,
                         alignment_genome_end=600))
        rows.append(dict(base, read_id=f"c{ch}", channel=ch, mux=1,
                         start_time=10.0 * ch + dt, alignment_direction=d2,
                         alignment_genome_start=s2,
                         alignment_genome_end=s2 + 500))
    rows.append(dict(rows[0], read_id="low", alignment_coverage=0.2))
    return rows[::-1]


def test_find_follow_on_matches_jax_on_a_summary_file(tmp_path):
    pd = pytest.importorskip("pandas")
    rows = _summary_rows()
    path = tmp_path / "summary.tsv"
    pd.DataFrame(rows).to_csv(path, sep="\t", index=False)
    want = jduplex.find_follow_on(pd.read_csv(path, sep="\t"))
    got = tduplex.find_follow_on(tduplex.read_summary(str(path)))
    assert got == want == [("t1", "c1")]


def test_duplex_consensus_matches_jax():
    rng = np.random.default_rng(4)
    s1, s2 = _seqs(rng, 2, 80)
    q1 = "".join(chr(33 + int(q)) for q in rng.integers(5, 40, len(s1)))
    q2 = "".join(chr(33 + int(q)) for q in rng.integers(5, 40, len(s2)))
    c2 = reverse_complement_str(s2)
    for args in ((s1, q1, c2, q2), (s1, q1, "", ""), ("", "", c2, q2)):
        assert tduplex.duplex_consensus(*args) == \
            jduplex.duplex_consensus(*args)


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    """A small CRF model and a fast5 file of two simulated template /
    complement pairs of one sequence each."""
    h5py = pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("duplex")
    _crf_dir(root / "model")
    rng = np.random.default_rng(11)
    pore = load_pore_model()
    (root / "reads").mkdir()
    with h5py.File(root / "reads" / "batch0.fast5", "w") as fh:
        for p in range(2):
            seq = "".join(rng.choice(list("ACGT"), size=700))
            for kind, s in (("t", seq), ("c", reverse_complement_str(seq))):
                codes = np.array(["NACGTXY".index(c) for c in s], np.uint8)
                sig, _ = simulate_squiggle(codes, pore, rng)
                rid = f"{kind}{p}"
                g = fh.create_group(f"read_{rid}")
                g.attrs["read_id"] = rid
                raw = g.create_group("Raw")
                raw.create_dataset("Signal", data=np.clip(
                    sig * 60 + 500, 0, 4000).astype(np.int16))
                raw.attrs["read_number"] = p
                ch = g.create_group("channel_id")
                ch.attrs["range"] = 1400.0
                ch.attrs["digitisation"] = 8192.0
                ch.attrs["offset"] = 10.0
                ch.attrs["sampling_rate"] = 4000.0
    (root / "pairs.txt").write_text("t0 c0\n# comment\nt1\tc1\n")
    return root


@pytest.fixture()
def f32_clis(monkeypatch):
    """Both packages basecall in f32, where their output must be
    identical."""
    from xna_basecaller_tpu_torch.infer import basecall as tb
    monkeypatch.setattr(jbasecall, "basecall", functools.partial(
        jbasecall.basecall, compute_dtype=jnp.float32))
    monkeypatch.setattr(tb, "basecall", functools.partial(
        tb.basecall, compute_dtype=torch.float32))


@pytest.mark.parametrize("flags", [[], ["--pair-decode"]])
def test_duplex_cli_fastq_matches_jax_cli(pair_dir, capsys, f32_clis, flags,
                                         monkeypatch):
    """With ``--pair-decode`` the oracle is JAX's CLI with the complement
    strand reverse-complemented through the alphabet
    (``test_torch_crf.py``)."""
    args = ["duplex", str(pair_dir / "model"), str(pair_dir / "reads"),
            "--pairs", str(pair_dir / "pairs.txt"), "--chunksize", "1200",
            "--overlap", "200", "--batchsize", "4", *flags]
    if "--pair-decode" in flags:
        flip = jcrf.reverse_complement

        def corrected(scores, n_base, state_len):
            return jnp.asarray(relabel_columns(
                np.asarray(flip(scores, n_base, state_len)),
                to_complement(n_base, "NACGTXY"[:n_base + 1]), n_base,
                state_len))
        monkeypatch.setattr(jcrf, "reverse_complement", corrected)
    jax_cli(args)
    want = capsys.readouterr().out
    port_cli([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    heads = [x for x in got.splitlines() if x.startswith("@")]
    assert [h.split()[0] for h in heads] == ["@t0;duplex", "@t1;duplex"]
    assert all("dx:i:1" in h and "cp:Z:c" in h for h in heads)


def test_duplex_cli_needs_pairs_or_summary(pair_dir):
    with pytest.raises(SystemExit) as exc:
        port_cli(["duplex", str(pair_dir / "model"), str(pair_dir / "reads"),
                  "--device", "cpu"])
    assert "needs --pairs or --summary" in str(exc.value)


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """A CRF model with two checkpoints and a ctc-data validation set."""
    root = tmp_path_factory.mktemp("evaluate")
    cfg, _ = _crf_dir(root / "model")
    jckpt.save_checkpoint(str(root / "model"), 2,
                          JaxModel(cfg).init(jax.random.key(1)))
    c, t, l, _ = simulate_ctc_dataset(10, chunk_len=1000, target_len=100,
                                      seed=3)
    save_ctc_data(str(root / "data" / "validation"), c, t, l)
    return root


def _stable_lines(text):
    return [x for x in text.splitlines()
            if not x.startswith(("* time", "* samples/s", "* poa time"))]


@pytest.mark.parametrize("flags", [["--weights", "1,2", "--poa"],
                                   ["--weights", "0"]])
def test_evaluate_matches_jax_cli(eval_dirs, capsys, monkeypatch, flags):
    from xna_basecaller_tpu.train import loop as jloop
    from xna_basecaller_tpu_torch.train import loop as tloop
    monkeypatch.setattr(jloop, "eval_scores", functools.partial(
        jloop.eval_scores, compute_dtype=jnp.float32))
    monkeypatch.setattr(tloop, "eval_scores", functools.partial(
        tloop.eval_scores, compute_dtype=torch.float32))
    args = ["evaluate", str(eval_dirs / "model"), "--directory",
            str(eval_dirs / "data"), "--batchsize", "4", *flags]
    jax_cli(args)
    want = capsys.readouterr().out
    port_cli([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert _stable_lines(got) == _stable_lines(want)
    n_poa = sum(x.startswith("* poa mean") for x in got.splitlines())
    assert n_poa == ("--poa" in flags)


@pytest.mark.parametrize("family", ["crf", "ctc"])
def test_view_matches_jax_cli(tmp_path, capsys, family):
    # the ctc case: a QuartzNet of quartznet5x5_config's kinds of block (a
    # strided conv, separable residual repeats with dropout, a pointwise
    # conv) at small widths; both packages' view describe and build the
    # CRF model of the config's encoder (JAX's initialises its parameters),
    # so that is small too (with the default blank score: the other head)
    cfg = (ModelConfig(encoder=EncoderConfig(features=48, num_rnn_layers=3,
                                             blank_score=None))
           if family == "crf" else ModelConfig(
               labels=tuple("NACGTXY"), blocks=(
                   BlockConfig(filters=16, repeat=1, kernel=(9,),
                               stride=(3,)),
                   BlockConfig(filters=24, repeat=2, kernel=(7,),
                               residual=True, separable=True, dropout=0.1),
                   BlockConfig(filters=32, repeat=1, kernel=(1,))),
               encoder=EncoderConfig(features=48, num_rnn_layers=3),
               package="xna_basecaller_tpu.models.ctc_model"))
    jconfig.save(cfg, str(tmp_path))
    jax_cli(["view", str(tmp_path)])
    want = capsys.readouterr().out
    port_cli(["view", str(tmp_path)])
    assert capsys.readouterr().out == want


def test_export_matches_jax_cli(eval_dirs, tmp_path, capsys):
    for w in ("0", "1"):
        jax_cli(["export", str(eval_dirs / "model"), "--output",
                 str(tmp_path / "j.json"), "--weights", w])
        port_cli(["export", str(eval_dirs / "model"), "--output",
                  str(tmp_path / "p.json"), "--weights", w, "--device",
                  "cpu"])
        capsys.readouterr()
        assert (tmp_path / "p.json").read_bytes() == \
            (tmp_path / "j.json").read_bytes()
