"""Port of ``xna_basecaller_tpu/augment/spike.py``: spike augmentation,
synthetic-signal UB insertion, on the training device.

Semantics of the reference's per-item CPU augmentation (reference:
ub-bonito/bonito/spike_chunks.py), run over the whole batch at once:

* UB positions are drawn by iterative masked sampling (reference
  choose_positions, spike_chunks.py:194-215: avoid 10-base edges, a +-pad
  window around each pick, and +-2*pad around pre-existing UBs).
* For each spiked position the signal span breakpoints[pos-6]..
  breakpoints[pos] is replaced by a synthetic squiggle of the 11-mer around
  the UB: per-k-mer dwell repetitions from the breakpoints, level means
  from the pore-model table, within-event std sampling per ``std_dist``
  plus truncated-normal noise (sim_signals, spike_chunks.py:54-134),
  normalised by the med/MAD of a simulated full-read squiggle
  (compute_med_mad_squiggly, spike_chunks.py:44-52).
* ``fully_synth`` replaces the whole chunk with simulated signal
  (sim_target, spike_chunks.py:217-245).

Fixed shapes as in JAX: spikes per chunk are capped at ``max_spikes``,
each spike writes into a ``MAX_SPAN``-sample window with masking, and the
med/MAD uses ``MEDMAD_REPS`` dwell repetitions.

Every function takes the batch as its leading axis (JAX vmaps a per-chunk
function) and draws from one ``torch.Generator`` on the batch's device.
The random bits differ from JAX's; the distributions are the same.  Where
no draw enters the result (zero k-mer stds, no noise, one valid position,
one UB code) the result is JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from xna_basecaller_tpu_torch.data.pore_model import load_pore_model
from xna_basecaller_tpu_torch.utils.device import resolve_device

KMER_LEN = 6
MAX_SPAN = 160          # max signal samples replaced per spike
MEDMAD_REPS = 8         # dwell reps for the med/MAD simulation (ref: 100)
MAD_FACTOR = 1.4826
_SQRT2 = math.sqrt(2.0)


def _uniform(gen, shape, low, high, device):
    """U[low, high) in f32 (``jax.random.uniform(minval, maxval)``); the
    bounds may be tensors that broadcast to ``shape``."""
    return torch.rand(shape, generator=gen, device=device) * (high - low) \
        + low


def _truncated_normal(gen, lower, upper, shape, device):
    """A standard normal truncated to (lower, upper), by the inverse CDF as
    ``jax.random.truncated_normal`` draws it; the bounds may be tensors
    that broadcast to ``shape``."""
    lower = torch.as_tensor(lower, dtype=torch.float32, device=device)
    upper = torch.as_tensor(upper, dtype=torch.float32, device=device)
    u = _uniform(gen, shape, torch.erf(lower / _SQRT2),
                 torch.erf(upper / _SQRT2), device)
    out = _SQRT2 * torch.erfinv(u)
    inf = torch.tensor(math.inf, device=device)
    return torch.minimum(torch.maximum(out, torch.nextafter(lower, inf)),
                         torch.nextafter(upper, -inf))


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[b, idx[b, ...]]`` for src [B, N] and idx [B, ...]."""
    return src.gather(1, idx.reshape(idx.shape[0], -1)).view(idx.shape)


def _put(dst: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
         values: torch.Tensor) -> torch.Tensor:
    """A copy of dst [B, N] with ``dst[b, idx] = values`` where ``mask``,
    as ``.at[idx].set(values, mode="drop")``: masked lanes and indices
    outside the row write into an extra column that is sliced off, so no
    kept index is written twice (CUDA orders no duplicate writes)."""
    n = dst.shape[1]
    idx = idx.reshape(idx.shape[0], -1)
    keep = mask.reshape(idx.shape) & (idx >= 0) & (idx < n)
    buf = torch.cat([dst, dst.new_zeros(dst.shape[0], 1)], 1)
    buf.scatter_(1, torch.where(keep, idx, n),
                 values.reshape(idx.shape).to(dst.dtype))
    return buf[:, :n]


def _dilate(mask: torch.Tensor, r: int) -> torch.Tensor:
    """[B, L] bool: any ``mask`` within +-r, as JAX's "same" convolution
    with ``ones(2r + 1)`` tested > 0 (a max pool is exact)."""
    return F.max_pool1d(mask.float()[:, None], 2 * r + 1, stride=1,
                        padding=r)[:, 0] > 0


def _n_positions(lengths: torch.Tensor, prop, n_existing: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """min(max(round(length * prop) - n_existing, 1), cap): the product of
    the int32 lengths and ``prop`` in f32, rounded half to even, as
    ``jnp.round(length * prop)`` computes it."""
    n = torch.round(lengths.to(torch.int32) * prop).long() - n_existing
    return n.clamp(1, cap)


def _kmer_codes_from_target(target: torch.Tensor, n_base: int = 6,
                            k: int = KMER_LEN) -> torch.Tensor:
    """Dense k-mer codes per position from base codes [..., L] (1..6 ->
    0..5): code[i] indexes the pore model for target[i:i+k]; windows past
    the end run into an AT tail (JAX's clamped form of the reference's
    get_kmers_model AT-tail convention, spike_chunks.py:21-42)."""
    z = (target - 1).clamp(0, n_base - 1)
    tail = torch.tensor([0, 3] * ((k + 1) // 2), dtype=z.dtype,
                        device=z.device)[:k]
    padded = torch.cat([z, tail.expand(*z.shape[:-1], k)], -1)
    windows = padded.unfold(-1, k, 1)[..., :z.shape[-1], :]     # [..., L, k]
    pows = n_base ** torch.arange(k - 1, -1, -1, device=z.device)
    return (windows * pows).sum(-1)


def _sample_event_stds(gen, stds: torch.Tensor, std_dist: str):
    """Within-event std sampling (reference sim_signals std_dist modes,
    spike_chunks.py:66-110): stds [..., n] -> offsets [..., n].  The
    ``*_shift_*`` modes draw one shift for each leading index (one spike,
    or one chunk)."""
    dev, shape = stds.device, stds.shape
    if std_dist == "uniform":
        return _uniform(gen, shape, -1.0, 1.0, dev) * stds
    if std_dist.startswith(("uniform_shift_", "truncnorm_shift_")):
        kind, _, std_len, shift_range = std_dist.split("_")
        std_len, shift_range = float(std_len), float(shift_range)
        n_choices = int(round(2 * shift_range / 0.5)) + 1
        shift = -shift_range + 0.5 * torch.randint(
            0, n_choices, (*shape[:-1], 1), generator=gen,
            device=dev).float()
        if kind == "uniform":
            return (_uniform(gen, shape, -std_len, std_len, dev)
                    + shift) * stds
        return _truncated_normal(gen, -std_len + shift, std_len + shift,
                                 shape, dev) * stds
    if std_dist == "truncnorm":
        return _truncated_normal(gen, -2.0, 2.0, shape, dev) * stds
    if std_dist == "normal":
        t = torch.randn(shape, generator=gen, device=dev) * 0.5
        return t.clamp(-2.0, 2.0) * stds
    raise ValueError(f"unsupported std_dist {std_dist!r}")


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis: (lo + hi) * 0.5 of the two middle
    values of an even count (``torch.median`` returns the lower one)."""
    s = x.sort(-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _med_mad_squiggly(gen, means, stds, valid):
    """med/MAD [B] of a simulated full-read squiggle per row of means,
    stds, valid [B, L] (reference compute_med_mad_squiggly,
    spike_chunks.py:44-52), with invalid positions masked and reduced
    dwell reps."""
    reps_means = means.repeat_interleave(MEDMAD_REPS, -1)
    reps_stds = stds.repeat_interleave(MEDMAD_REPS, -1)
    reps_valid = valid.repeat_interleave(MEDMAD_REPS, -1)
    sig = reps_means + _uniform(gen, reps_means.shape, -1.0, 1.0,
                                means.device) * reps_stds
    # masked median: invalid entries become -big and +big alternately, so
    # they push the median neither way
    half = torch.arange(sig.shape[-1], device=means.device) % 2 == 0
    sentinel = torch.where(half, -1e6, 1e6)
    med = _median(torch.where(reps_valid, sig, sentinel))
    dev = torch.where(reps_valid, (sig - med[..., None]).abs(), sentinel)
    mad = _median(dev) * MAD_FACTOR + 1e-7
    return med, mad


def _choose_positions(gen, length, n_pos, max_spikes: int, pad: int,
                      ubs_pos_mask, weights=None):
    """Masked iterative sampling of positions (reference choose_positions,
    spike_chunks.py:194-215; with ``weights`` [B, L] the
    k-mer-frequency-weighted variant, stitch_chunks.py:46-102): picks
    [B, max_spikes], -1 where none was made.

    Each of the ``max_spikes`` rounds draws one position per row in
    proportion to its weight over the positions still valid (10 bases from
    either end, outside +-2*pad of an existing UB and +-pad of an earlier
    pick): the first position whose cumulative weight exceeds a uniform
    fraction u of the total, as ``jax.random.choice`` with ``p`` searches
    its cumulative sum.  Such a position has a positive weight, since
    u < 1.  A round past a row's ``n_pos`` searches at u = 1, and a row
    with no weight left has a total of 0: neither finds a position (JAX
    draws from a uniform ``p`` there and discards the pick).

    The rounds read nothing back from the device and launch five kernels
    each: the weights lie in a buffer with ``pad`` zeros on their left and
    ``2 pad + 2`` on their right, so that "none" is the index W past the
    searched part and every pick's +-pad window, "none"'s too, is one
    scatter of zeros inside the buffer."""
    B, L = ubs_pos_mask.shape
    dev = ubs_pos_mask.device
    pos_idx = torch.arange(L, device=dev)
    valid = ((pos_idx >= 10) & (pos_idx < length[:, None] - 10)
             & ~ubs_pos_mask)
    w = valid.float() if weights is None else valid.float() * weights
    u = torch.rand(max_spikes, B, 1, generator=gen, device=dev)
    u = torch.where(torch.arange(max_spikes, device=dev)[:, None, None]
                    < n_pos[:, None], u, 1.0)
    W = L + 2 * pad + 1
    buf = torch.zeros(B, W + pad + 1, device=dev)
    buf[:, pad:pad + L] = w
    searched = buf[:, :W]
    window = torch.arange(-pad, pad + 1, device=dev)
    picks = torch.empty(max_spikes, B, 1, dtype=torch.long, device=dev)
    for i in range(max_spikes):
        cum = torch.cumsum(searched, -1)
        torch.searchsorted(cum, cum[:, -1:] * u[i], right=True,
                           out=picks[i])
        buf.scatter_(1, picks[i] + window, 0.0)
    picks = picks[..., 0].T
    return torch.where(picks < W, picks - pad, -1)


def spike_batch(gen, chunks, targets, lengths, breakpoints,
                kmer_means, kmer_stds,
                prop_ubs: float = 0.10, max_spikes: int = 64,
                pad: int = 5, std_dist: str = "truncnorm_shift_1.5_0.5",
                noise_std: float = 1.0, fully_synth: bool = False,
                ub_codes: tuple = (5, 6), var_prop_ubs: float = 0.0,
                mix_ubs: bool = True):
    """Spike augmentation over a batch on its device.

    chunks [B, T] f32, targets [B, L] int, lengths [B] int, breakpoints
    [B, L] int cumulative; kmer_means/kmer_stds the pore tables on the same
    device.  Returns (chunks' f32, targets' int32)."""
    if pad < KMER_LEN - 1:
        # picks are only guaranteed pad+1 apart; the single-scatter write
        # needs the [bkps[pos-6], bkps[pos]) spans pairwise disjoint
        raise ValueError(
            f"spike pad must be >= {KMER_LEN - 1} (got {pad}): smaller "
            "pads allow overlapping replacement spans")
    dev = chunks.device
    B, T = chunks.shape
    L = targets.shape[1]
    target, length = targets.long(), lengths.long()
    pos_idx = torch.arange(L, device=dev)
    in_len = pos_idx < length[:, None]
    # padded breakpoint entries are zeros: a sentinel past the chunk keeps
    # the searches over the cumulative boundaries well-defined
    bkps = torch.where(in_len, breakpoints.long(), T + 1)

    # existing UBs: avoid spiking within 2*pad of them
    is_ub = (target > 4) & in_len
    ub_window = _dilate(is_ub, 2 * pad)
    prop = prop_ubs
    if var_prop_ubs > 0:
        # per-item proportion jitter (reference spike_read,
        # spike_chunks.py:256-257)
        prop = prop_ubs + _uniform(gen, (B,), -var_prop_ubs, var_prop_ubs,
                                   dev)
    n_pos = _n_positions(lengths, prop, is_ub.sum(-1), max_spikes)
    picks = _choose_positions(gen, length, n_pos, max_spikes, pad,
                              ub_window)
    picked = picks >= 0

    codes = torch.tensor(ub_codes, device=dev)
    if mix_ubs:
        # mixed UBs: ub_codes repeated, shuffled per chunk
        reps = codes.repeat(-(-max_spikes // len(ub_codes)))[:max_spikes]
        spiked_ubs = reps[torch.rand(B, max_spikes, generator=gen,
                                     device=dev).argsort(-1)]
    else:
        # one UB type for the whole chunk (reference spike_chunks.py:278-279)
        one_ub = codes[torch.randint(0, len(ub_codes), (B, 1), generator=gen,
                                     device=dev)]
        spiked_ubs = one_ub.expand(B, max_spikes)

    new_target = target
    if tuple(ub_codes) != (0,):  # ubs == ['N'] -> signal-only spiking
        new_target = _put(target, picks, picked, spiked_ubs)

    # per-position k-mer levels AFTER UB insertion (spike-then-simulate,
    # reference spike_chunk:177-183)
    kcodes = _kmer_codes_from_target(new_target)
    means, stds = kmer_means[kcodes], kmer_stds[kcodes]
    med, mad = _med_mad_squiggly(gen, means, stds, in_len)

    if fully_synth:
        return (_sim_full(gen, chunks, length, bkps, means, stds, med, mad,
                          std_dist, noise_std), new_target.int())

    # every spike as one [B, M, MAX_SPAN] block and one masked scatter: the
    # picks are >= pad+1 apart, so the spans [bkps[pos-6], bkps[pos]) are
    # pairwise disjoint
    pos = picks.clamp(0, L - 1)                               # [B, M]
    start = torch.where(pos >= KMER_LEN,
                        _take(bkps, (pos - KMER_LEN).clamp(min=0)), 0)
    span = (_take(bkps, pos) - start).clamp(0, MAX_SPAN)
    samp = torch.arange(MAX_SPAN, device=dev)
    abs_pos = start[..., None] + samp                         # [B, M, S]
    # the span covers k-mers pos-5..pos with boundaries bkps[pos-6..pos]
    kidx = pos[..., None] - KMER_LEN + torch.arange(KMER_LEN + 1,
                                                    device=dev)
    kmer_starts = torch.where(kidx >= 0, _take(bkps, kidx.clamp(0, L - 1)),
                              0)                              # [B, M, 7]
    which = ((abs_pos[..., None] >= kmer_starts[:, :, None, :]).sum(-1)
             - 1).clamp(0, KMER_LEN - 1)                      # [B, M, S]
    kmer_pos = (pos[..., None] - (KMER_LEN - 1) + which).clamp(0, L - 1)
    m, s = _take(means, kmer_pos), _take(stds, kmer_pos)
    # one std shift per spike (sim_signals per spike, spike_chunks.py:166-190)
    sig = m + _sample_event_stds(gen, s, std_dist)
    if noise_std > 0:
        sig = sig + _truncated_normal(gen, -3.0, 3.0, sig.shape,
                                      dev) * noise_std
    sig = (sig - med[:, None, None]) / mad[:, None, None]
    write = (samp < span[..., None]) & picked[..., None]
    return _put(chunks, abs_pos, write, sig), new_target.int()


def _sim_full(gen, chunks, length, bkps, means, stds, med, mad, std_dist,
              noise_std):
    """Whole-chunk synthetic signal (reference sim_target,
    spike_chunks.py:217-245), dwell reps from the breakpoints; samples past
    the last breakpoint keep the chunk's."""
    B, T = chunks.shape
    L = bkps.shape[1]
    samp = torch.arange(T, device=chunks.device)
    # base index per signal sample from the cumulative breakpoints
    which = torch.searchsorted(bkps, samp.expand(B, T).contiguous(),
                               right=True).clamp(0, L - 1)
    m, s = _take(means, which), _take(stds, which)
    sig = m + _sample_event_stds(gen, s, std_dist)
    if noise_std > 0:
        sig = sig + _truncated_normal(gen, -3.0, 3.0, sig.shape,
                                      chunks.device) * noise_std
    sig = (sig - med[:, None]) / mad[:, None]
    total = _take(bkps, (length - 1).clamp(0, L - 1)[:, None])
    return torch.where(samp < total, sig, chunks)


def _upload(device, chunks, targets, lengths, breakpoints):
    """The numpy batch of a ``ChunkDataset`` as tensors on ``device``:
    chunks f32, the rest int32."""
    return (torch.from_numpy(np.ascontiguousarray(chunks, np.float32)
                             ).to(device),
            *(torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
              for a in (targets, lengths, breakpoints)))


_UB_CODE_MAP = {"X": (5,), "Y": (6,), "XY": (5, 6), "N": (0,)}


def make_spike_augment(ubs: str = "XY", prop_ubs: float = 0.10,
                       noise_std: float = 1.0,
                       std_dist: str = "truncnorm_shift_1.5_0.5",
                       fully_synth: bool = False, pore_model_path=None,
                       max_spikes: int = 64, pad: int = 5,
                       var_prop_ubs: float = 0.0, mix_ubs: bool = True,
                       device: str | torch.device = "cuda"):
    """Build a ``ChunkDataset`` augment(chunks, targets, lengths,
    breakpoints, rng) -> (chunks, targets) closure that spikes on
    ``device``: numpy in, numpy out.  The pore tables are uploaded once;
    each call seeds a generator on the device from ``rng`` as JAX seeds its
    key."""
    dev = resolve_device(device)
    pore = load_pore_model(pore_model_path)
    kmer_means = torch.from_numpy(pore.means).to(dev)
    kmer_stds = torch.from_numpy(pore.stds).to(dev)
    ub_codes = _UB_CODE_MAP[ubs]

    def augment(chunks, targets, lengths, breakpoints, rng):
        seed = int(rng.integers(0, 2 ** 31 - 1))
        gen = torch.Generator(device=dev).manual_seed(seed)
        c, t = spike_batch(
            gen, *_upload(dev, chunks, targets, lengths, breakpoints),
            kmer_means, kmer_stds,
            prop_ubs=prop_ubs, max_spikes=max_spikes, pad=pad,
            std_dist=std_dist, noise_std=noise_std,
            fully_synth=fully_synth, ub_codes=ub_codes,
            var_prop_ubs=var_prop_ubs, mix_ubs=mix_ubs)
        return c.cpu().numpy(), t.cpu().numpy()

    return augment
