"""The plain versions of the loss kernels (K4, K5a, K5b, K6a, K6b; CPU)
against the JAX package's Pallas functions in interpret mode, as
``test_pallas.py`` runs them.

Inputs come from a numpy seed: scores tanh(normal) * 5 and, for the
lattice, the stay/move gather of random targets whose lengths differ per
row.  Tolerances: the scans (alphas, betas, logZ) rtol 1e-5, since each
step keeps the Pallas op order and only the last bits of exp/log and of
the summation differ between the two libraries; the edge posteriors rtol
1e-4 with atol 1e-7, and the lattice gradients rtol 1e-4 with atol 1e-6
(the JAX package's own bound for them, ``test_pallas.py:316``), because
each is exp() of a difference of log-sums, which magnifies those last bits
and leaves posteriors far below the largest with a few ulps of absolute
error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xna_basecaller_tpu.ops import crf_pallas
from xna_basecaller_tpu_torch.ops import crf, crf_cuda

# (n_base, state_len, T, N, target width L)
CASES = [(4, 2, 10, 3, 9), (6, 3, 16, 2, 10)]


def _scores(n_base, state_len, T, N, seed):
    C = (n_base + 1) * n_base ** state_len
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.standard_normal((T, N, C))) * 5).astype(np.float32)


def _lattice(n_base, state_len, T, N, L, seed):
    """stay [T, N, n], move [T, N, n-1] and the lattice lengths [N]
    (length - state_len + 1, a different one on every row)."""
    s = torch.from_numpy(_scores(n_base, state_len, T, N, seed))
    rng = np.random.default_rng(seed + 1)
    lengths = np.array([L, L - 2, L - 1][:N], np.int64)
    targets = np.zeros((N, L), np.int64)
    for i, n in enumerate(lengths):
        targets[i, :n] = rng.integers(1, n_base + 1, size=n)
    stay, move = crf.prepare_ctc_scores(s, torch.from_numpy(targets),
                                        n_base, state_len)
    return stay, move, torch.from_numpy(lengths + 1 - state_len)


def _tn(x):
    """[T, N, ns] -> the Pallas layout [T, ns, N]."""
    return x.permute(0, 2, 1).numpy()


@pytest.mark.parametrize("n_base,state_len,T,N,L", CASES)
def test_forward_scan_matches_pallas(n_base, state_len, T, N, L):
    s = _scores(n_base, state_len, T, N, seed=1)
    want_a, want_z = crf_pallas.forward_scan_pallas(
        jnp.asarray(s), n_base, state_len, interpret=True)
    alphas = crf.forward_scores(torch.from_numpy(s), n_base, state_len)
    np.testing.assert_allclose(_tn(alphas[:-1]), np.asarray(want_a),
                               rtol=1e-5)
    np.testing.assert_allclose(crf.logz_from_alphas(alphas).numpy(),
                               np.asarray(want_z), rtol=1e-5)


@pytest.mark.parametrize("n_base,state_len,T,N,L", CASES)
def test_backward_scan_matches_pallas(n_base, state_len, T, N, L):
    s = _scores(n_base, state_len, T, N, seed=2)
    want = crf_pallas.backward_scan_pallas(jnp.asarray(s), n_base,
                                           state_len, interpret=True)
    betas = crf.backward_scores(torch.from_numpy(s), n_base, state_len)
    np.testing.assert_allclose(_tn(betas[1:]), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("n_base,state_len,T,N,L", CASES)
def test_edge_posteriors_match_pallas(n_base, state_len, T, N, L):
    s = _scores(n_base, state_len, T, N, seed=3)
    want = crf_pallas.edge_posteriors_pallas(jnp.asarray(s), n_base,
                                             state_len, interpret=True)
    st = torch.from_numpy(s)
    alphas = crf.forward_scores(st, n_base, state_len)
    betas = crf.backward_scores(st, n_base, state_len)
    post = crf.edge_posteriors(st, alphas, betas,
                               crf.logz_from_alphas(alphas))
    np.testing.assert_allclose(post.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)
    # the cotangent is one multiply after the exp
    ct = torch.from_numpy(np.random.default_rng(4).standard_normal(N)
                          .astype(np.float32))
    scaled = crf.edge_posteriors(st, alphas, betas,
                                 crf.logz_from_alphas(alphas), ct)
    torch.testing.assert_close(scaled, post * ct[None, :, None], rtol=0,
                               atol=0)


@pytest.mark.parametrize("n_base,state_len,T,N,L", CASES)
def test_lattice_forward_matches_pallas(n_base, state_len, T, N, L):
    stay, move, lengths = _lattice(n_base, state_len, T, N, L, seed=5)
    want = crf_pallas.ctc_lattice_logz_pallas(
        jnp.asarray(stay.numpy()), jnp.asarray(move.numpy()),
        jnp.asarray(lengths.numpy()), interpret=True)
    alphas, logz = crf.lattice_forward(stay, move, lengths)
    assert alphas.shape == stay.shape
    np.testing.assert_allclose(logz.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("n_base,state_len,T,N,L", CASES)
def test_lattice_backward_matches_pallas(n_base, state_len, T, N, L):
    stay, move, lengths = _lattice(n_base, state_len, T, N, L, seed=6)
    ct = np.random.default_rng(7).standard_normal(N).astype(np.float32)
    want_ds, want_dm, want_z = crf_pallas.ctc_lattice_grads_pallas(
        jnp.asarray(stay.numpy()), jnp.asarray(move.numpy()),
        jnp.asarray(lengths.numpy()), jnp.asarray(ct), interpret=True)
    alphas, logz = crf.lattice_forward(stay, move, lengths)
    np.testing.assert_allclose(logz.numpy(), np.asarray(want_z), rtol=1e-5)
    d_stay, d_move = crf.lattice_backward(stay, move, lengths, alphas, logz,
                                          torch.from_numpy(ct))
    np.testing.assert_allclose(d_stay.numpy(), np.asarray(want_ds),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(d_move.numpy(), np.asarray(want_dm),
                               rtol=1e-4, atol=1e-6)


def test_loss_on_cpu_tensors_takes_the_plain_path():
    n_base, state_len, T, N, L = CASES[1]
    s = torch.from_numpy(_scores(n_base, state_len, T, N, seed=8))
    s.requires_grad_()
    _, _, lengths = _lattice(n_base, state_len, T, N, L, seed=8)
    targets = torch.ones(N, L, dtype=torch.int64)
    wrappers = (crf_cuda.forward_scan, crf_cuda.backward_scan,
                crf_cuda.edge_posteriors, crf_cuda.lattice_forward,
                crf_cuda.lattice_backward)
    before = [w.launches for w in wrappers]
    crf.ctc_loss(s, targets, lengths + state_len - 1, n_base,
                 state_len).backward()
    assert bool(torch.isfinite(s.grad).all())
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("offset", [0, 1, 2])
def test_scan_scores_are_copied_only_when_not_8_byte_aligned(offset):
    """The wrappers of the ring's scans (K2a/K5a, K4) give their kernels
    scores that start 8-byte aligned, so that every row takes one of the
    ring's two routes (``csrc/crf_ring.cuh``): scores that start at an odd
    float (4 bytes into an 8-byte word) are copied, any others pass as they
    are."""
    C = 6 * 5 ** 3   # a 5-letter model's rows: 3000 B
    flat = torch.arange(offset + 3 * 2 * C, dtype=torch.float32)
    s = flat[offset:].view(3, 2, C)
    assert s.data_ptr() % 8 == (4 if offset == 1 else 0)
    got = crf_cuda._ring_aligned(s)
    assert (got is not s) == (offset == 1)
    assert got.data_ptr() % 8 == 0 and got.is_contiguous()
    assert torch.equal(got, s)


# n = 4, 5, 6, 7: n = 0, 1, 2 and 3 mod 4; 1: no move at all
@pytest.mark.parametrize("n", [4, 5, 6, 7, 1])
def test_lattice_pack_layout(n):
    """``lattice_pack`` lays stay and move out as K6a and K6b read them,
    as JAX's ``_lat_pack`` does: [T, N, 2, npad], npad = n rounded up to 4;
    row 0 the stay, row 1 the move into each position (slot j holds move
    j-1); slot 0 of the move row and the pads -1e38.  ``lattice_unpack``
    gives stay and move back exactly, as views that the wrappers take
    without packing again."""
    T, N = 3, 2
    rng = np.random.default_rng(n)
    stay = torch.from_numpy(rng.standard_normal((T, N, n)).astype(np.float32))
    move = torch.from_numpy(
        rng.standard_normal((T, N, n - 1)).astype(np.float32))
    lat = crf_cuda.lattice_pack(stay, move)
    npad = -(-n // 4) * 4
    assert lat.shape == (T, N, 2, npad) and lat.is_contiguous()
    assert torch.equal(lat[:, :, 0, :n], stay)
    for j in range(1, n):
        assert torch.equal(lat[:, :, 1, j], move[:, :, j - 1])
    neg = torch.tensor(-1e38, dtype=torch.float32)
    for pad in (lat[:, :, 0, n:], lat[:, :, 1, :1], lat[:, :, 1, n:]):
        assert bool((pad == neg).all())
    got_s, got_m = crf_cuda.lattice_unpack(lat, n)
    assert torch.equal(got_s, stay) and torch.equal(got_m, move)
    assert crf_cuda._packed(got_s, got_m).data_ptr() == lat.data_ptr()
    assert torch.equal(crf_cuda._packed(stay, move), lat)


def test_lattice_alphas_at_row_stride_npad():
    """K6b reads the alphas at K6a's row stride npad: a view of such
    alphas passes as it is, contiguous [T, N, n] alphas are copied into
    that layout."""
    T, N, n, npad = 3, 2, 5, 8
    full = torch.arange(T * N * npad, dtype=torch.float32).view(T, N, npad)
    view = full[:, :, :n]
    assert crf_cuda._padded(view, npad).data_ptr() == full.data_ptr()
    copied = crf_cuda._padded(view.contiguous(), npad)
    assert copied.shape == (T, N, npad)
    assert copied.data_ptr() != full.data_ptr()
    assert torch.equal(copied[:, :, :n], view)


@pytest.mark.parametrize("n_base,state_len,T,N,L", CASES)
def test_lattice_logz_gradient_through_the_pack(n_base, state_len, T, N, L):
    """logZ and the gradient of ``ctc_lattice_logz`` (which packs the
    gather's slices once for K6a and K6b; the plain versions on the CPU,
    reading the packed views) are those of the plain versions on
    contiguous stay and move, bit for bit."""
    stay, move, lengths = _lattice(n_base, state_len, T, N, L, seed=9)
    ct = torch.from_numpy(
        np.random.default_rng(10).standard_normal(N).astype(np.float32))
    n = stay.shape[2]
    both = torch.cat([stay, move], 2).requires_grad_()
    lz = crf.ctc_lattice_logz(both[:, :, :n], both[:, :, n:], lengths)
    lz.backward(ct)
    alphas, want_z = crf.lattice_forward(stay.contiguous(),
                                         move.contiguous(), lengths)
    d_stay, d_move = crf.lattice_backward(stay.contiguous(),
                                          move.contiguous(), lengths, alphas,
                                          want_z, ct)
    assert torch.equal(lz.detach(), want_z)
    assert torch.equal(both.grad[:, :, :n], d_stay)
    assert torch.equal(both.grad[:, :, n:], d_move)
