"""The port's decoders (plain PyTorch, CPU) against the JAX package: the
q-score decode, the beam decode, the Max-semiring traceback and logZ,
``compute_transition_probs``, ``ctc_viterbi_alignments``, the ``CTCCRF``
methods, the vectorised q-string and the q-score and beam decodes of
``infer/basecall.py``.

Tolerances: labels, paths, one-hots and alignments exact on these seeded
fixtures (no f32 near-ties, the caveat of
tests/test_reference_parity_e2e.py); the q-score probabilities within
1e-6 plus 4 ulps of |logZ| relative (each is exp() of an edge that
subtracts logZ, which the two packages' scans round differently in its
last bits: one ulp of |logZ| = 80 is 7.6e-6, and it scales every
probability of the row alike);
``compute_transition_probs`` the same way, by 4 ulps of |beta| (a softmax
of score + beta); Max-semiring scores exact (max
and add round alike); Log-semiring logZ and posteriors 1e-5.  The beam's
best_score, a sum of T edges each of which subtracts logZ, within
1e-5 T of JAX's where each package runs its own scans (their logZ differ
in the last bits: ~4e-6 at T=12 with 4 bases), and within 1e-5 where the
port's beam search runs on JAX's own alphas, betas and logZ.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.data.writers import phred
from xna_basecaller_tpu_torch.data.writers import qstring
from xna_basecaller_tpu.infer import basecall as jbasecall
from xna_basecaller_tpu.ops import crf as jcrf
from xna_basecaller_tpu_torch.infer import basecall as tbasecall
from xna_basecaller_tpu_torch.ops import crf, crf_cuda

from test_torch_crf import jax_input

ALPHABETS = [(2, 1), (4, 3), (6, 3)]


def _scores(n_base, state_len, T=12, N=3, seed=0):
    C = (n_base + 1) * n_base ** state_len
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.standard_normal((T, N, C))) * 5).astype(np.float32)


@pytest.mark.parametrize("n_base,state_len", ALPHABETS)
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_paths_with_qual_matches_jax(n_base, state_len, seed):
    s = _scores(n_base, state_len, T=16, N=4, seed=seed)
    want_l, want_p = jcrf.decode_paths_with_qual(jnp.asarray(s), n_base,
                                                 state_len)
    got_l, got_p = crf.decode_paths_with_qual(torch.from_numpy(s), n_base,
                                              state_len)
    assert got_l.dtype == torch.int8 and got_p.dtype == torch.float32
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    logz = np.abs(np.asarray(jcrf.logz_fwd(jnp.asarray(s), n_base,
                                           state_len))).max()
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=4 * np.spacing(np.float32(logz)),
                               atol=1e-6)
    # the chain's wrapper takes the plain version on the CPU
    for a, b in zip(crf_cuda.decode_paths_with_qual_cuda(
            torch.from_numpy(s), n_base, state_len), (got_l, got_p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_base,state_len", ALPHABETS)
def test_qual_variants_extend_the_viterbi_decode(n_base, state_len):
    """The plain q-score K2b and K2c give the Viterbi decode's bp, v_final
    and labels, and the probs are exp() of edge_sel along the path."""
    s = torch.from_numpy(_scores(n_base, state_len, seed=4))
    betas = crf.backward_scores(s, n_base, state_len)
    logz = crf.logz_from_betas(betas)
    bp, v = crf.forward_viterbi(s, betas, logz, n_base, state_len)
    bp_q, v_q, edge_sel = crf.forward_viterbi(s, betas, logz, n_base,
                                              state_len, qual=True)
    assert torch.equal(bp, bp_q) and torch.equal(v, v_q)
    labels, probs = crf.viterbi_traceback(bp, v, n_base, state_len,
                                          edge_sel)
    assert torch.equal(labels, crf.viterbi_traceback(bp, v, n_base,
                                                     state_len))
    assert bool(((probs > 0) & (probs <= 1 + 1e-6)).all())
    assert torch.equal(labels, crf.decode_paths(s, n_base, state_len))


def _partials(s, n_base, state_len):
    j = jnp.asarray(s)
    alphas = jcrf.forward_scores(j, n_base, state_len)
    betas = jcrf.backward_scores(j, n_base, state_len)
    logz = jcrf.semiring_sum(alphas[-1], -1, jcrf.LOG)
    return [torch.from_numpy(np.array(x)) for x in (alphas, betas, logz)]


@pytest.mark.parametrize("beam_width", [1, 4, 8, 128])
@pytest.mark.parametrize("n_base,state_len", ALPHABETS)
def test_decode_beam_matches_jax(n_base, state_len, beam_width):
    T = 12
    s = _scores(n_base, state_len, T=T, seed=beam_width)
    want_l, want_s = jcrf.decode_beam(jnp.asarray(s), n_base, state_len,
                                      beam_width)
    got_l, got_s = crf.decode_beam(torch.from_numpy(s), n_base, state_len,
                                   beam_width)
    assert got_l.dtype == torch.int8 and got_l.shape == (3, T)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-5 * T)
    # the port's beam search on JAX's own partials
    got_l, got_s = crf.beam_search(torch.from_numpy(s),
                                   *_partials(s, n_base, state_len), n_base,
                                   state_len, beam_width)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-5)
    # the chain's wrapper takes the plain version on the CPU
    paths, best = crf_cuda.decode_beam_cuda(torch.from_numpy(s), n_base,
                                            state_len, beam_width)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(want_l))


def test_beam_hash_wraps_at_32_bits():
    """h * P + label mod 2**32 held in int64, for uint32 hashes at the top
    of their range and both multipliers (numpy's uint32 arithmetic is the
    reference)."""
    h = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 123456789, 4000000000],
                 np.uint32)
    for p in (crf._HASH_P1, crf._HASH_P2):
        for lab in (1, 6):
            want = h * np.uint32(p) + np.uint32(lab)
            got = crf._hash_step(torch.from_numpy(h.astype(np.int64)), p,
                                 torch.tensor(lab))
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _edge_log_posteriors(scores, n_base, state_len):
    """[T, N, ns, nb+1] log edge posteriors of the port's posteriors."""
    post = crf.posteriors(torch.from_numpy(scores), n_base,
                          state_len).double().numpy()
    T, N, _ = scores.shape
    ns = n_base ** state_len
    return np.log(np.maximum(post.reshape(T, N, ns, n_base + 1), 1e-300))


def _sequence_masses(e, n_base, state_len):
    """e: [T, ns, nb+1] edge log-posteriors of one read.  Every transition
    path enumerated, grouped by its emitted labels, log-sum-exp within each
    group (JAX's tests/test_crf_beam.py)."""
    T, ns, nb1 = e.shape
    nsd = ns // n_base
    groups = {}

    def extend(t, state, logp, seq):
        if t == T:
            groups[seq] = np.logaddexp(groups.get(seq, -np.inf), logp)
            return
        if t == 0:
            for j, k in itertools.product(range(ns), range(nb1)):
                extend(1, j, logp + e[0, j, k], seq + ((k,) if k else ()))
            return
        extend(t + 1, state, logp + e[t, state, 0], seq)
        dropped = state // nsd
        for b2 in range(n_base):
            j = (state % nsd) * n_base + b2
            extend(t + 1, j, logp + e[t, j, 1 + dropped],
                   seq + (dropped + 1,))

    extend(0, -1, 0.0, ())
    return groups


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_matches_brute_force(seed):
    """A wide beam returns the sequence of most posterior mass, with that
    mass as its score (tests/test_crf_beam.py:66-84, on the port)."""
    n_base, state_len, T, N = 2, 1, 5, 2
    rng = np.random.default_rng(seed)
    C = (n_base ** state_len) * (n_base + 1)
    scores = rng.normal(0, 1.5, (T, N, C)).astype(np.float32)
    e = _edge_log_posteriors(scores, n_base, state_len)
    labels, best = crf.decode_beam(torch.from_numpy(scores), n_base,
                                   state_len, beam_width=128)
    for n in range(N):
        groups = _sequence_masses(e[:, n], n_base, state_len)
        want = max(groups, key=groups.get)
        assert tuple(int(x) for x in labels[n] if x != 0) == want
        assert math.isclose(float(best[n]), groups[want], rel_tol=0,
                            abs_tol=2e-4)


def test_beam_can_beat_viterbi_on_sequence_posterior():
    """The beam's sequence has at least the Viterbi sequence's posterior
    mass on every read, and more on some (tests/test_crf_beam.py:87-139,
    on the port)."""
    n_base, state_len, T, N = 2, 1, 6, 8
    rng = np.random.default_rng(7)
    C = (n_base ** state_len) * (n_base + 1)
    scores = rng.normal(0, 1.0, (T, N, C)).astype(np.float32)
    e = _edge_log_posteriors(scores, n_base, state_len)
    beam, _ = crf.decode_beam(torch.from_numpy(scores), n_base, state_len,
                              beam_width=128)
    vit = crf.decode_paths(torch.from_numpy(scores), n_base, state_len)
    better = 0
    for n in range(N):
        groups = _sequence_masses(e[:, n], n_base, state_len)

        def mass(labels):
            return groups.get(tuple(int(x) for x in labels if x != 0),
                              -np.inf)
        lp_beam, lp_vit = mass(beam[n]), mass(vit[n])
        assert lp_beam >= lp_vit - 1e-6
        better += lp_beam > lp_vit + 1e-6
    assert better >= 1


def test_beam_on_a_peaked_path_is_the_viterbi_call():
    """6 bases, 216 states: on scores with one dominant path, beam and
    Viterbi call the same sequence (tests/test_crf_beam.py:142-175)."""
    n_base, state_len, T, N = 6, 3, 12, 2
    ns = n_base ** state_len
    rng = np.random.default_rng(3)
    scores = rng.normal(0, 0.1, (T, N, ns * (n_base + 1))).astype(np.float32)
    for n in range(N):
        state = int(rng.integers(ns))
        for t in range(T):
            if rng.random() < 0.5:
                scores[t, n, state * (n_base + 1)] += 12.0
            else:
                dropped = state // (ns // n_base)
                state = (state % (ns // n_base)) * n_base + int(
                    rng.integers(n_base))
                scores[t, n, state * (n_base + 1) + 1 + dropped] += 12.0
    beam, _ = crf.decode_beam(torch.from_numpy(scores), n_base, state_len,
                              beam_width=8)
    vit = crf.decode_paths(torch.from_numpy(scores), n_base, state_len)
    for n in range(N):
        assert [x for x in beam[n].tolist() if x] \
            == [x for x in vit[n].tolist() if x]


@pytest.mark.parametrize("n_base,state_len", ALPHABETS)
def test_compute_transition_probs_matches_jax(n_base, state_len):
    s = _scores(n_base, state_len, seed=7)
    want = jcrf.compute_transition_probs(jnp.asarray(s), n_base, state_len)
    got = crf.compute_transition_probs(torch.from_numpy(s), n_base,
                                       state_len)
    betas = np.abs(np.asarray(jcrf.backward_scores(jnp.asarray(s), n_base,
                                                   state_len))).max()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=4 * np.spacing(np.float32(betas)),
                                   atol=1e-6)


@pytest.mark.parametrize("n_base,state_len", ALPHABETS)
@pytest.mark.parametrize("seed", [0, 1])
def test_viterbi_path_and_onehot_match_jax(n_base, state_len, seed):
    s = _scores(n_base, state_len, seed=10 + seed)
    j, t = jnp.asarray(s), torch.from_numpy(s)
    got = crf.viterbi_path(t, n_base, state_len)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcrf.viterbi_path(j, n_base, state_len)))
    labels, states = crf._viterbi_traceback(t, n_base, state_len)
    want_l, want_s = jcrf._viterbi_traceback(j, n_base, state_len)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(states.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(
        crf._viterbi_onehot(t, n_base, state_len).numpy(),
        np.asarray(jcrf._viterbi_onehot(j, n_base, state_len)))


def _lattice(seed, T=14, N=4, n=6):
    rng = np.random.default_rng(seed)
    stay = rng.standard_normal((T, N, n)).astype(np.float32)
    move = rng.standard_normal((T, N, n - 1)).astype(np.float32)
    lengths = rng.integers(1, n + 1, N).astype(np.int32)
    return stay, move, lengths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_viterbi_alignments_match_jax(seed):
    stay, move, lengths = _lattice(seed)
    want = jcrf.ctc_viterbi_alignments(jnp.asarray(stay), jnp.asarray(move),
                                       jnp.asarray(lengths))
    got = crf.ctc_viterbi_alignments(torch.from_numpy(stay),
                                     torch.from_numpy(move),
                                     torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ctc_viterbi_alignments_of_one_position():
    stay, move, lengths = _lattice(3, n=1)
    got = crf.ctc_viterbi_alignments(torch.from_numpy(stay),
                                     torch.from_numpy(move),
                                     torch.from_numpy(lengths))
    assert torch.equal(got, torch.ones(14, 4, 1))


@pytest.mark.parametrize("semiring", ["log", "max"])
@pytest.mark.parametrize("n_base,state_len", ALPHABETS)
def test_semiring_scans_logz_and_posteriors_match_jax(n_base, state_len,
                                                      semiring):
    s = _scores(n_base, state_len, seed=20)
    j, t = jnp.asarray(s), torch.from_numpy(s)
    tol = 1e-5 if semiring == "log" else 0
    for got, want in (
            (crf.forward_scores(t, n_base, state_len, semiring),
             jcrf.forward_scores(j, n_base, state_len, semiring)),
            (crf.backward_scores(t, n_base, state_len, semiring),
             jcrf.backward_scores(j, n_base, state_len, semiring)),
            (crf.logz(t, n_base, state_len, semiring),
             jcrf.logz_fwd(j, n_base, state_len, semiring)),
            (crf.posteriors(t, n_base, state_len, semiring),
             jcrf.posteriors(j, n_base, state_len, semiring))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)


def test_max_logz_gradient_is_the_viterbi_onehot():
    """The Max-semiring logZ's backward: the one-hot best path times the
    cotangent, as JAX's custom VJP gives it."""
    s = _scores(4, 3, seed=21)
    ct = np.array([0.5, -2.0, 1.25], np.float32)
    x = torch.from_numpy(s).requires_grad_()
    (crf.logz(x, 4, 3, "max") * torch.from_numpy(ct)).sum().backward()
    want = jnp.asarray(ct)[None, :, None] * jcrf.posteriors(
        jnp.asarray(s), 4, 3, "max")
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


def test_semiring_refuses_other_names():
    t = torch.from_numpy(_scores(2, 1))
    for fn in (crf.logz, crf.posteriors):
        with pytest.raises(ValueError):
            fn(t, 2, 1, "tropical")


def test_ctccrf_methods_match_jax():
    seqdist, jseq = crf.CTCCRF(3, "NACGT"), jcrf.CTCCRF(3, "NACGT")
    s = _scores(4, 3, T=14, N=3, seed=22)
    j, t = jnp.asarray(s), torch.from_numpy(s)
    np.testing.assert_array_equal(seqdist.viterbi(t).numpy(),
                                  np.asarray(jseq.viterbi(j)))
    for semiring, tol in (("log", 1e-5), ("max", 0)):
        np.testing.assert_allclose(
            seqdist.logZ(t, semiring).detach().numpy(),
            np.asarray(jseq.logZ(j, semiring)), rtol=tol, atol=tol)
        np.testing.assert_allclose(
            seqdist.posteriors(t, semiring).numpy(),
            np.asarray(jseq.posteriors(j, semiring)), rtol=tol, atol=tol)
    assert seqdist.decode_beam_batch(t, 4) == jseq.decode_beam_batch(j, 4)
    np.testing.assert_array_equal(
        seqdist.reverse_complement(t).numpy(),
        np.asarray(jseq.reverse_complement(j)))
    rng = np.random.default_rng(5)
    targets = rng.integers(1, 5, (3, 8)).astype(np.int64)
    lengths = np.array([8, 6, 5], np.int64)
    np.testing.assert_array_equal(
        seqdist.ctc_viterbi_alignments(t, torch.from_numpy(targets),
                                       torch.from_numpy(lengths)).numpy(),
        np.asarray(jseq.ctc_viterbi_alignments(j, jnp.asarray(targets),
                                               jnp.asarray(lengths))))


def _f16_probabilities():
    """Every f16 value in [0, 1], as f32: what the q-score decode hands
    the host."""
    v = np.arange(2 ** 16, dtype=np.uint16).view(np.float16)
    return v[np.isfinite(v) & (v >= 0) & (v <= 1)].astype(np.float32)


@pytest.mark.parametrize("scale,bias", [(1.0, 0.0), (1.37, -2.25)])
def test_qstring_equals_the_phred_loop_on_every_f16(scale, bias):
    """The vectorised q-string equals JAX's per-base ``phred`` loop
    (``infer/basecall.py:343-346`` there) on all ~15k f16 values in
    [0, 1]: the model config's default scale and bias, and another."""
    p = _f16_probabilities()
    assert len(p) > 15000
    want = "".join(phred(x, scale=scale, bias=bias) for x in p)
    assert qstring(p, scale, bias) == want


def test_qstring_of_no_bases_and_of_probabilities_past_one():
    assert qstring(np.zeros(0, np.float32)) == ""
    p = np.array([1.0, 1.0009766, 0.5], np.float32)   # f16 1 + 2**-10
    assert qstring(p, 1.2, 0.5) == "".join(
        phred(x, scale=1.2, bias=0.5) for x in p)


@pytest.mark.parametrize("reverse,ub_bias", [(False, 0.0), (True, 0.5)])
def test_score_and_decode_qual_matches_jax(reverse, ub_bias):
    """On R the oracle is JAX's decode of the corrected reverse complement
    (``test_torch_crf.py``: the port complements through the alphabet)."""
    s = _scores(6, 3, T=16, N=2, seed=8)
    want_p, want_q = jbasecall._score_and_decode_qual(
        jax_input(s, reverse), 6, 3, False, ub_bias)
    got_p, got_q = tbasecall._score_and_decode_qual(
        torch.from_numpy(s), 6, 3, reverse, ub_bias, "NACGTXY")
    assert got_p.dtype == torch.int8 and got_q.dtype == torch.float16
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


@pytest.mark.parametrize("reverse,ub_bias", [(False, 0.0), (True, -0.5)])
def test_score_and_decode_beam_matches_jax(reverse, ub_bias):
    s = _scores(6, 3, T=16, N=2, seed=9)
    want = jbasecall._score_and_decode_beam(jax_input(s, reverse), 6, 3, 4,
                                            False, ub_bias)
    got = tbasecall._score_and_decode_beam(torch.from_numpy(s), 6, 3, 4,
                                           reverse, ub_bias, "NACGTXY")
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
