"""Port CRF decode (plain PyTorch, CPU) against the JAX package.

Labels must be equal to ``crf.decode_paths`` and to the Pallas decode
(interpret mode) on these seeded fixtures, which have no f32 near-ties;
alphas, betas and logZ agree at 1e-5; ``reverse_complement`` and
``_apply_ub_bias`` are exact.

``reverse_complement`` deliberately departs from JAX's, which complements
base i as n_base - 1 - i: right for NACGT, where the port stays bit-equal
to JAX, and A<->Y, C<->X, G<->T for NACGTXY.  There the oracle is JAX's
output with each base relabelled to the alphabet's complement
(``corrected_revcomp``), and a decode of R-strand scores equals JAX's with
its labels relabelled by sigma = complement o flip (``relabel_fastq``)
wherever no decode meets an exact tie.  The helpers take the complement
map from the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.core.alphabet import COMPLEMENT as JCOMPLEMENT
from xna_basecaller_tpu.infer import basecall as jbasecall
from xna_basecaller_tpu.ops import crf as jcrf
from xna_basecaller_tpu.ops import crf_pallas
from xna_basecaller_tpu_torch.infer import basecall as tbasecall
from xna_basecaller_tpu_torch.ops import crf, crf_cuda

CASES = [(6, 3), (4, 2), (4, 5)]


def complement_perm(alphabet: str) -> np.ndarray:
    """perm[i]: the base index of the complement of ``alphabet[i + 1]``."""
    bases = alphabet[1:]
    return np.array([bases.index(JCOMPLEMENT[b]) for b in bases])


def relabel_columns(x: np.ndarray, g: np.ndarray, n_base: int,
                    state_len: int) -> np.ndarray:
    """x [..., n_state * (n_base + 1)] (scores, or transition posteriors
    flattened as scores are) with every base axis of a column, the k-mer's
    and the emission's, read through g: out[..., (b_1..b_k, e)] =
    x[..., (g(b_1)..g(b_k), g(e))]; the stay column stays."""
    lead = x.shape[:-1]
    w = x.reshape(lead + (n_base,) * state_len + (n_base + 1,))
    for axis in range(state_len):
        w = np.take(w, g, axis=len(lead) + axis)
    w = np.take(w, np.r_[0, g + 1], axis=len(lead) + state_len)
    return w.reshape(x.shape)


def to_complement(n_base: int, alphabet: str) -> np.ndarray:
    """g: JAX's complement of each base (the flip) is base g(b)'s
    complement in the alphabet's map."""
    return n_base - 1 - complement_perm(alphabet)


def corrected_revcomp(s, n_base: int, state_len: int, alphabet: str):
    """The oracle of the port's ``reverse_complement``: JAX's, each base
    relabelled from JAX's complement to the alphabet's."""
    want = np.asarray(jcrf.reverse_complement(jnp.asarray(s), n_base,
                                              state_len))
    return relabel_columns(want, to_complement(n_base, alphabet), n_base,
                           state_len)


def relabel_fastq(text: str, alphabet: str = "NACGTXY") -> str:
    """JAX's FASTQ of an R-strand call with each base b written as
    sigma(b) = complement(flip(b)): the port's call of the same scores."""
    bases = alphabet[1:]
    perm = complement_perm(alphabet)
    table = str.maketrans(bases, "".join(
        bases[perm[len(bases) - 1 - i]] for i in range(len(bases))))
    lines = text.split("\n")
    for i in range(1, len(lines), 4):
        lines[i] = lines[i].translate(table)
    return "\n".join(lines)


def _scores(n_base, state_len, T=14, N=3, seed=0):
    C = (n_base + 1) * n_base ** state_len
    rng = np.random.default_rng(seed)
    s = np.tanh(rng.standard_normal((T, N, C))) * 5.0
    return s.astype(np.float32)


@pytest.mark.parametrize("n_base,state_len", CASES)
def test_scans_and_logz_match(n_base, state_len):
    s = _scores(n_base, state_len)
    st = torch.from_numpy(s)
    betas = crf.backward_scores(st, n_base, state_len)
    np.testing.assert_allclose(
        betas.numpy(), np.asarray(jcrf.backward_scores(
            jnp.asarray(s), n_base, state_len)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        crf.forward_scores(st, n_base, state_len).numpy(),
        np.asarray(jcrf.forward_scores(jnp.asarray(s), n_base, state_len)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        crf.logz_from_betas(betas).numpy(),
        np.asarray(jcrf.logz_fwd(jnp.asarray(s), n_base, state_len)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_base,state_len", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_labels_match(n_base, state_len, seed):
    s = _scores(n_base, state_len, T=20, N=4, seed=seed)
    want = np.asarray(jcrf.decode_paths(jnp.asarray(s), n_base, state_len))
    want_pal = np.asarray(crf_pallas.decode_paths_pallas(
        jnp.asarray(s), n_base, state_len, interpret=True))
    got = crf.decode_paths(torch.from_numpy(s), n_base, state_len)
    assert got.dtype == torch.int8 and got.shape == (4, 20)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_pal)
    # the kernel chain's wrappers take the plain versions on the CPU
    np.testing.assert_array_equal(
        crf_cuda.decode_paths_cuda(torch.from_numpy(s), n_base,
                                   state_len).numpy(), want)


@pytest.mark.parametrize("n_base,state_len", CASES)
def test_reverse_complement_exact(n_base, state_len):
    """NACGT: bit-equal to JAX's; NACGTXY: JAX's relabelled to the
    alphabet's complement.  The default alphabet is the canonical one of
    n_base bases, and the reverse complement is its own inverse."""
    s = _scores(n_base, state_len, seed=5)
    alphabet = "NACGTXY"[:n_base + 1]
    got = crf.reverse_complement(torch.from_numpy(s), n_base, state_len,
                                 alphabet)
    np.testing.assert_array_equal(
        got.numpy(), corrected_revcomp(s, n_base, state_len, alphabet))
    if n_base == 4:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jcrf.reverse_complement(
                jnp.asarray(s), n_base, state_len)))
    assert torch.equal(crf.reverse_complement(torch.from_numpy(s), n_base,
                                              state_len), got)
    assert torch.equal(crf.reverse_complement(got, n_base, state_len,
                                              alphabet),
                       torch.from_numpy(s))


def test_reverse_complement_refuses_an_alphabet_open_under_complement():
    """NACGTX has X but not its complement Y: a ValueError naming X, not
    silently wrong scores."""
    s = torch.from_numpy(_scores(5, 2))
    with pytest.raises(ValueError, match="base 'X' has no complement"):
        crf.reverse_complement(s, 5, 2, "NACGTX")
    with pytest.raises(ValueError, match="base 'X'"):
        crf.reverse_complement(s, 5, 2)
    with pytest.raises(ValueError, match="base 'X'"):
        crf.CTCCRF(2, "NACGTX").reverse_complement(s)


@pytest.mark.parametrize("ub_bias", [0.0, 0.7, -1.25])
def test_apply_ub_bias_exact(ub_bias):
    s = _scores(6, 3, seed=6)
    np.testing.assert_array_equal(
        tbasecall._apply_ub_bias(torch.from_numpy(s), 6, ub_bias).numpy(),
        np.asarray(jbasecall._apply_ub_bias(jnp.asarray(s), 6, ub_bias)))


def jax_input(s, reverse: bool):
    """The scores to give JAX's F-strand decode for the port's decode of
    6-base scores ``s`` on ``reverse``: on R, the corrected reverse
    complement."""
    if reverse:
        return jnp.asarray(corrected_revcomp(s, 6, 3, "NACGTXY"))
    return jnp.asarray(s)


@pytest.mark.parametrize("reverse,ub_bias", [(False, 0.0), (True, 0.5)])
def test_score_and_decode_matches(reverse, ub_bias):
    """On R the oracle is JAX's decode of the corrected reverse
    complement (the UB bias, added after it, rules out relabelling the
    labels)."""
    s = _scores(6, 3, T=16, N=2, seed=8)
    want = np.asarray(jbasecall._score_and_decode(
        jax_input(s, reverse), 6, 3, False, ub_bias))
    got = tbasecall._score_and_decode(torch.from_numpy(s), 6, 3, reverse,
                                      ub_bias, "NACGTXY")
    np.testing.assert_array_equal(got.numpy(), want)


def test_traceback_follows_backpointers():
    """K2c's plain version on hand-made backpointers: a move from state j
    through column k lands on (k-1)*nsd + j//n_base."""
    n_base, state_len = 4, 2          # 16 states, nsd = 4
    T, N, ns = 3, 1, 16
    bp = torch.zeros(T, N, ns, dtype=torch.uint8)
    v_final = torch.zeros(N, ns)
    v_final[0, 9] = 1.0               # start from state 9
    bp[2, 0, 9] = 3                   # move: j -> 2*4 + 9//4 = 10
    bp[1, 0, 10] = 0                  # stay at 10
    bp[0, 0, 10] = 1                  # move
    labels = crf.viterbi_traceback(bp, v_final, n_base, state_len)
    assert labels.tolist() == [[1, 0, 3]]


@pytest.mark.parametrize("offset", [0, 1])
def test_decode_chain_aligns_scores_once_for_both_scans(monkeypatch, offset):
    """``decode_paths_cuda`` hands K2a and K2b one tensor, 8-byte aligned
    as their ring takes it: scores that start at an odd float are copied
    once, for both; the labels are the plain decode's."""
    seen = []
    for name in ("backward_scan", "forward_viterbi"):
        def spy(scores, *args, real=getattr(crf_cuda, name)):
            seen.append(scores)
            return real(scores, *args)
        monkeypatch.setattr(crf_cuda, name, spy)
    s = torch.from_numpy(_scores(6, 3))
    flat = torch.zeros(offset + s.numel())
    flat[offset:] = s.flatten()
    scores = flat[offset:].view(s.shape)
    assert scores.data_ptr() % 8 == 4 * offset
    labels = crf_cuda.decode_paths_cuda(scores, 6, 3)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert seen[0].data_ptr() % 8 == 0 and torch.equal(seen[0], s)
    assert torch.equal(labels, crf.decode_paths(s, 6, 3))


def test_path_to_str():
    seqdist = crf.CTCCRF(3, "NACGTXY")
    assert seqdist.path_to_str(np.array([0, 1, 0, 5, 6, 0, 4])) == "AXYT"
    assert seqdist.n_state == 216 and seqdist.n_score == 1512
