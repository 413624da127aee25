"""The port's CTC-CRF loss (plain PyTorch, CPU) against the JAX package's
XLA branch (``XNACALL_PALLAS_LOSS=0`` is what the CPU runs anyway).

f32 throughout.  Tolerances: ``prepare_ctc_scores`` exact (a gather);
the loss, logZ and the posteriors rtol 1e-5 (the same scans with the same
op order); the loss's gradient with respect to the scores rtol 1e-4 with
atol 1e-7, because posteriors far below the largest come out of exp() of
a difference of large log-sums, whose last bits differ between the two
libraries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.ops import crf as jcrf
from xna_basecaller_tpu_torch.ops import crf

CASES = [("NACGTXY", 3), ("NACGT", 3), ("NACGT", 2)]


def _inputs(alphabet, state_len, T=40, N=3, L=12, seed=0):
    nb = len(alphabet) - 1
    C = (nb + 1) * nb ** state_len
    rng = np.random.default_rng(seed)
    scores = (np.tanh(rng.standard_normal((T, N, C))) * 5).astype(np.float32)
    targets = np.zeros((N, L), np.int32)
    lengths = rng.integers(state_len + 2, L + 1, size=N).astype(np.int32)
    for i, n in enumerate(lengths):
        targets[i, :n] = rng.integers(1, nb + 1, size=n)
    return nb, scores, targets, lengths


@pytest.mark.parametrize("alphabet,state_len", CASES)
def test_prepare_ctc_scores_exact(alphabet, state_len):
    nb, s, t, _ = _inputs(alphabet, state_len)
    js, jm = jcrf.prepare_ctc_scores(jnp.asarray(s), jnp.asarray(t), nb,
                                     state_len)
    ps, pm = crf.prepare_ctc_scores(torch.from_numpy(s), torch.from_numpy(t),
                                    nb, state_len)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("alphabet,state_len", CASES)
def test_logz_and_posteriors_match_jax(alphabet, state_len):
    nb, s, _, _ = _inputs(alphabet, state_len, seed=1)
    lz = crf.logz(torch.from_numpy(s), nb, state_len)
    np.testing.assert_allclose(
        lz.numpy(), np.asarray(jcrf.logz_fwd(jnp.asarray(s), nb, state_len)),
        rtol=1e-5)
    post = crf.posteriors(torch.from_numpy(s), nb, state_len)
    want = np.asarray(jcrf.posteriors(jnp.asarray(s), nb, state_len))
    np.testing.assert_allclose(post.numpy(), want, rtol=1e-4, atol=1e-7)
    # the posteriors are the gradient of logZ: autograd through the
    # Function gives them back
    x = torch.from_numpy(s).requires_grad_()
    crf.logz(x, nb, state_len).sum().backward()
    torch.testing.assert_close(x.grad, post, rtol=0, atol=0)


@pytest.mark.parametrize("alphabet,state_len", CASES)
def test_ctc_loss_and_grad_match_jax(alphabet, state_len):
    nb, s, t, l = _inputs(alphabet, state_len, seed=2)
    args = (jnp.asarray(t), jnp.asarray(l), nb, state_len)
    j_none = np.asarray(jcrf.ctc_loss(jnp.asarray(s), *args,
                                      reduction="none"))
    j_mean, j_grad = jax.value_and_grad(
        lambda x: jcrf.ctc_loss(x, *args, reduction="mean"))(jnp.asarray(s))
    x = torch.from_numpy(s).requires_grad_()
    tt, tl = torch.from_numpy(t), torch.from_numpy(l)
    p_none = crf.ctc_loss(x, tt, tl, nb, state_len, reduction="none")
    np.testing.assert_allclose(p_none.detach().numpy(), j_none, rtol=1e-5)
    p_mean = crf.ctc_loss(x, tt, tl, nb, state_len)
    np.testing.assert_allclose(p_mean.item(), float(j_mean), rtol=1e-5)
    p_mean.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-4, atol=1e-7)


def test_ctc_loss_clip_and_unnormalised_match_jax():
    nb, s, t, l = _inputs("NACGT", 3, seed=3)
    for kw in ({"loss_clip": 0.5}, {"normalise_scores": False}):
        want = np.asarray(jcrf.ctc_loss(jnp.asarray(s), jnp.asarray(t),
                                        jnp.asarray(l), nb, 3,
                                        reduction="none", **kw))
        got = crf.ctc_loss(torch.from_numpy(s), torch.from_numpy(t),
                           torch.from_numpy(l), nb, 3, reduction="none", **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_ctcrf_bundle_matches_functions():
    nb, s, t, l = _inputs("NACGTXY", 3, seed=4)
    bundle = crf.CTCCRF(3, "NACGTXY")
    st, tt, lt = (torch.from_numpy(a) for a in (s, t, l))
    torch.testing.assert_close(bundle.ctc_loss(st, tt, lt),
                               crf.ctc_loss(st, tt, lt, nb, 3))
    torch.testing.assert_close(bundle.logZ(st), crf.logz(st, nb, 3))
    jseqs = jcrf.CTCCRF(3, "NACGTXY").decode_batch(jnp.asarray(s))
    assert bundle.decode_batch(st) == jseqs
