"""Port of ``xna_basecaller_tpu/augment/stitch.py``: stitch (splice)
augmentation, real-XNA signal slices inserted on the training device.

The host side is copied from the JAX module (``StitchTables``,
``_tpl_code``, ``slice_xna_tables``, ``build_relax_fallback``,
``count_kmers``, ``load_kmer_weight_table``); only the package imports
differ.  The device side (``availability_mask``, ``position_weights``,
``stitch_batch`` and its transforms) is batched torch, with the batch as the
leading axis where JAX vmaps a per-chunk function, drawing from one
``torch.Generator`` on the batch's device: other random bits than JAX's,
the same distributions.

Semantics of the reference's splice augmentation (reference:
ub-bonito/bonito/stitch_chunks.py).  Offline (host, once per dataset):
``slice_xna_tables`` scans the real-XNA ctc-data for single-UB reads and
packs the signal slice around each UB into dense tables, bucketed like the
reference's groupby (stitch_chunks.py:226-234): per_kmer buckets are (ub,
kmer_ub_pos, template-code) where template is the 5 natural bases before
the UB (base-4 coded); the lookup side rebuilds the same key by rotating
the insert k-mer (stitch_chunks.py:364-377), which is valid because the
XNA library templates mirror the 5 bases on both sides of the UB
(stitch_chunks.py:468).

Online (device): choose insert positions (spike's rules), pick a UB, and
for each of the 6 k-mers covering it take a donor bucket, sample
``cand_sample_size`` candidates and keep the one closest in length to the
local dwell span (stitch_chunks.py:392-407), then resample it to the span
(linear within a k-mer only) and splice.  The in-window permute
(transform_chunk, stitch_chunks.py:294-297) and the noise transforms run
on the device too.

One deviation from JAX: ``make_stitch_augment`` raises on a donor table
with no candidate at all, where JAX trains on silently unaugmented data.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from xna_basecaller_tpu_torch.augment.spike import (
    _choose_positions, _dilate, _n_positions, _put, _take,
    _truncated_normal, _uniform, _upload,
)
from xna_basecaller_tpu_torch.core.alphabet import BASES, CODE
from xna_basecaller_tpu_torch.data.ctc_data import load_numpy_datasets
from xna_basecaller_tpu_torch.utils.device import resolve_device

KMER_LEN = 6
MAX_KMER_SPAN = 100     # max_kmer_cnt filter (stitch_chunks.py:158-160)
MAX_SPAN = 360          # max spliced signal span (6 k-mers)
N_TPL = 4 ** 5          # 1024 natural 5-base contexts


@dataclass
class StitchTables:
    """Dense per_kmer slice tables.

    signals [2, 6, 1024, cap, MAX_KMER_SPAN] f32 — (ub-5, kmer_ub_pos,
    tpl_code, candidate, samples); lens [..., cap] i32; counts [...] i32.
    """

    signals: np.ndarray
    lens: np.ndarray
    counts: np.ndarray

    @property
    def cap(self) -> int:
        return self.signals.shape[3]


def _tpl_code(bases: np.ndarray) -> int:
    """5 natural base codes (1..4) -> base-4 context code."""
    out = 0
    for b in bases:
        out = out * 4 + (int(b) - 1)
    return out


def slice_xna_tables(xna_ctc_dir: str, cap: int = 32, edge_len: int = 5,
                     max_kmer_cnt: int = MAX_KMER_SPAN,
                     seed: int = 0) -> StitchTables:
    """Scan single-UB XNA ctc-data into dense per_kmer slice tables
    (replaces slice_xna + pandas groupby, stitch_chunks.py:127-239).

    When a bucket overflows ``cap``, reservoir sampling keeps a uniform
    subset (the reference keeps all candidates and samples at lookup time;
    with cap >= cand_sample_size the sampled distribution matches).
    """
    chunks, targets, lengths, bkps = load_numpy_datasets(
        xna_ctc_dir, load_bkps=True)
    rng = np.random.default_rng(seed)
    signals = np.zeros((2, KMER_LEN, N_TPL, cap, MAX_KMER_SPAN), np.float32)
    lens = np.zeros((2, KMER_LEN, N_TPL, cap), np.int32)
    counts = np.zeros((2, KMER_LEN, N_TPL), np.int64)

    for read_idx in range(len(lengths)):
        length = int(lengths[read_idx])
        target = np.asarray(targets[read_idx, :length])
        bkp = np.asarray(bkps[read_idx, :length]).astype(np.int64)
        ub_hits = np.argwhere(target > 4)
        if len(ub_hits) == 0:
            continue
        ub_pos = int(ub_hits[0, 0])  # first UB (reference line 148)
        if not edge_len < ub_pos < length - edge_len:
            continue
        slice_bkp = bkp[ub_pos - KMER_LEN: ub_pos + 1]
        kmer_cnts = np.diff(slice_bkp)
        if max_kmer_cnt and kmer_cnts.max() > max_kmer_cnt:
            continue
        context = target[ub_pos - 5: ub_pos]
        if np.any(context > 4) or np.any(context == 0):
            continue  # multi-UB context or blank: not representable base-4
        tpl = _tpl_code(context)
        ub_idx = int(target[ub_pos]) - 5
        chunk = np.asarray(chunks[read_idx], np.float32)
        for kmer_idx in range(KMER_LEN):
            kmer_ub_pos = KMER_LEN - kmer_idx - 1
            st, en = int(slice_bkp[kmer_idx]), int(slice_bkp[kmer_idx + 1])
            seg = chunk[st:en]
            n = counts[ub_idx, kmer_ub_pos, tpl]
            if n < cap:
                slot = n
            else:  # reservoir
                j = rng.integers(0, n + 1)
                if j >= cap:
                    counts[ub_idx, kmer_ub_pos, tpl] += 1
                    continue
                slot = j
            L = min(len(seg), MAX_KMER_SPAN)
            signals[ub_idx, kmer_ub_pos, tpl, slot, :L] = seg[:L]
            signals[ub_idx, kmer_ub_pos, tpl, slot, L:] = 0
            lens[ub_idx, kmer_ub_pos, tpl, slot] = L
            counts[ub_idx, kmer_ub_pos, tpl] += 1
    return StitchTables(signals, lens,
                        np.minimum(counts, cap).astype(np.int32))


def build_relax_fallback(counts: np.ndarray) -> np.ndarray:
    """[2, 6, 1024] int32: per (ub, kmer_ub_pos), map every context code
    to an OCCUPIED context code — identity where the bucket has donors,
    else the occupied bucket sharing the deepest low-order digit suffix.

    The low-order base-4 digits of a context code are the bases nearest
    the UB on the 5' side (availability_mask builds codes in that order),
    which dominate the pore signal of the central k-mers — so the
    fallback donor's context agrees with the acceptor where it matters
    most.  Sparse-library rescue (``relax`` / --stitch-relax): a
    20-template library like POC occupies 10-27 of 1024 buckets and the
    exact-context match then inserts ~nothing (measured 0.03 UB/chunk,
    results/northstar_poc_r12/DIAGNOSIS.md); with full occupancy (CPLX)
    the fallback is the identity and behavior is unchanged.  The
    reference has no equivalent — its exact-match KeyError skip
    (stitch_chunks.py:392-430) is what starves its own POC quick-run
    (~15% UB acc, README.md:106).
    """
    n_ub, n_kup, n_tpl = counts.shape
    fb = np.tile(np.arange(n_tpl, dtype=np.int32), (n_ub, n_kup, 1))
    for u in range(n_ub):
        for k in range(n_kup):
            occ = np.flatnonzero(counts[u, k] > 0)
            if len(occ) == 0:
                continue  # no donors at all: counts stay 0 either way
            filled = counts[u, k] > 0
            for depth in range(4, -1, -1):
                mod = 4 ** depth
                reps: dict[int, int] = {}
                for o in occ:
                    s = int(o % mod)
                    if s not in reps or counts[u, k, o] > \
                            counts[u, k, reps[s]]:
                        reps[s] = int(o)
                unfilled = np.flatnonzero(~filled)
                for c in unfilled:
                    s = int(c % mod)
                    if s in reps:
                        fb[u, k, c] = reps[s]
                        filled[c] = True
    return fb


def _noise_transform(gen, sig, noise_std: float, noise_mode: str):
    """transform_chunk noise modes (stitch_chunks.py:299-319) on sig
    [..., S]: one draw of a level (or of the noise's scale) per span."""
    if not noise_std:
        return sig
    dev, lead = sig.device, (*sig.shape[:-1], 1)
    if noise_mode == "single":
        return sig + _truncated_normal(gen, -3.0, 3.0, sig.shape,
                                       dev) * noise_std
    if noise_mode == "single_variable":
        s = _uniform(gen, lead, 0.0, noise_std, dev)
        return sig + _truncated_normal(gen, -3.0, 3.0, sig.shape, dev) * s
    if noise_mode == "block_add":
        return sig + _uniform(gen, lead, -noise_std, noise_std, dev)
    if noise_mode == "block_mult":
        return sig * (1.0 + _uniform(gen, lead, -noise_std, noise_std, dev))
    raise ValueError(f"Invalid noise mode = {noise_mode}")


def _permute_transform(gen, sig, valid_len, win: int):
    """In-window sample permutation (reference transform_chunk,
    stitch_chunks.py:294-297) of sig [..., S]: shuffle the first
    ``valid_len`` [...] samples within fixed windows of ``win``, leaving
    the padding tail in place; one argsort over (window, random) keys.
    Fixed windows where the reference's array_split uses near-equal ones
    (distributional augmentation, not bit parity)."""
    idx = torch.arange(sig.shape[-1], device=sig.device)
    rand = torch.rand(sig.shape, generator=gen, device=sig.device)
    sort_key = torch.where(idx < valid_len[..., None],
                           (idx // win).float() + rand * 0.99,
                           1e6 + idx.float())
    return sig.gather(-1, sort_key.argsort(-1))


def _context_offsets(kmer_len: int, device) -> torch.Tensor:
    """[kmer_len, kmer_len - 1]: for the k-mer with the UB at kmer_ub_pos
    = kmer_len-1-ki, the offsets from the UB of its context bases, most
    significant base-4 digit first: after (pos+1 .. pos+ki), then before
    (pos-(kmer_len-1-ki) .. pos-1)."""
    return torch.tensor(
        [[1 + j for j in range(ki)]
         + [-(kmer_len - 1 - ki) + j for j in range(kmer_len - 1 - ki)]
         for ki in range(kmer_len)], device=device)


def _base4(digits: torch.Tensor) -> torch.Tensor:
    """Base-4 code of digits [..., n], the first most significant."""
    pows = 4 ** torch.arange(digits.shape[-1] - 1, -1, -1,
                             device=digits.device)
    return (digits * pows).sum(-1)


def availability_mask(target, length, tbl_counts, ub_codes,
                      kmer_len: int = KMER_LEN, tbl_fallback=None):
    """[B, n_codes, L] bool for target [B, L], length [B]: positions whose
    6 covering-k-mer donor buckets are all non-empty, per UB code in
    ``ub_codes``.

    The reference picks positions blind and falls back unmodified when a
    bucket has no exact-k-mer candidate (stitch_chunks.py:392-430) — cheap
    there because its slice library covers nearly all 1024 contexts.  With
    a sparser library, blind picking wastes most insertion attempts;
    masking the choice up front keeps the requested UB exposure without
    relaxing the exact-context match.  Per-code masks (not ANDed over
    codes) so a donor table populated for only one of the requested codes
    still yields that code's insertions.
    """
    L = target.shape[1]
    dev = target.device
    zt = (target - 1).clamp(0, 5)
    natural = (target >= 1) & (target <= 4)
    p = torch.arange(L, device=dev) + _context_offsets(
        kmer_len, dev)[..., None]                         # [k, k-1, L]
    pc = p.clamp(0, L - 1)
    ctx = _base4(zt[:, pc].clamp(0, 3).transpose(-1, -2))    # [B, k, L]
    good = (natural[:, pc] & (p >= 0)
            & (p < length[:, None, None, None])).all(2)      # [B, k, L]
    kup = torch.arange(kmer_len - 1, -1, -1, device=dev)[:, None]
    ok = []
    for code in ub_codes:
        eff = ctx if tbl_fallback is None else tbl_fallback[code - 5, kup,
                                                            ctx]
        ok.append((good & (tbl_counts[code - 5, kup, eff] > 0)).all(1))
    return torch.stack(ok, 1)


def stitch_batch(gen, chunks, targets, lengths, breakpoints,
                 tbl_signals, tbl_lens, tbl_counts,
                 prop_ubs: float = 0.10, max_stitches: int = 64,
                 pad: int = 5, cand_sample_size: int = 5,
                 ub_codes: tuple = (5, 6), noise_std: float = 0.0,
                 noise_mode: str = "single", weight_table=None,
                 permute_win_size: int = 0, tbl_fallback=None):
    """per_kmer stitch over a batch on its device; returns (chunks' f32,
    targets' int32, success [B] bool).

    chunks [B, T] f32, targets [B, L] int, lengths [B] int, breakpoints
    [B, L] int cumulative; the tables (``StitchTables`` as tensors, and
    ``build_relax_fallback``'s map) on the same device.  ``weight_table``
    [6, 1024] enables k-mer-frequency-weighted insert position picking
    (reference weighted_pos_pick, stitch_chunks.py:46).
    """
    if pad < KMER_LEN - 1:
        # picks are only guaranteed pad+1 apart; the single-scatter write
        # needs the [bkps[pos-6], bkps[pos]) spans pairwise disjoint
        raise ValueError(
            f"stitch pad must be >= {KMER_LEN - 1} (got {pad}): smaller "
            "pads allow overlapping insertion spans")
    dev = chunks.device
    B, T = chunks.shape
    L = targets.shape[1]
    M = max_stitches
    target, length = targets.long(), lengths.long()
    in_len = torch.arange(L, device=dev) < length[:, None]
    bkps = torch.where(in_len, breakpoints.long(), T + 1)

    is_ub = (target > 4) & in_len
    ub_window = _dilate(is_ub, 2 * pad)
    n_pos = _n_positions(lengths, prop_ubs, is_ub.sum(-1), M)
    avail = availability_mask(target, length, tbl_counts, ub_codes,
                              tbl_fallback=tbl_fallback)    # [B, C, L]
    pos_w = avail.any(1).float()
    if weight_table is not None:
        pos_w = pos_w * position_weights(target, length, weight_table)
    picks = _choose_positions(gen, length, n_pos, M, pad, ub_window,
                              weights=pos_w)
    picked = picks >= 0
    pos = picks.clamp(0, L - 1)                              # [B, M]

    # UB code per stitch: uniform over the codes available at the picked
    # position (a one-code donor table still inserts that code)
    codes = torch.tensor(ub_codes, device=dev)
    code_ok = avail.gather(2, pos[:, None, :].expand(-1, len(ub_codes), -1)
                           ).transpose(1, 2)                 # [B, M, C]
    r_code = torch.where(code_ok, torch.rand(code_ok.shape, generator=gen,
                                             device=dev), 2.0)
    spiked_ubs = codes[r_code.argmin(-1)]                    # [B, M]
    ub_idx = (spiked_ubs - 5)[..., None]                     # [B, M, 1]

    # every insertion as one [B, M, ...] block: the picks are >= pad+1
    # apart, so the spans [bkps[pos-6], bkps[pos]) are pairwise disjoint
    ins_st = _take(bkps, (pos - KMER_LEN).clamp(0, L - 1))
    ins_en = _take(bkps, pos)
    # per-k-mer dwell spans from the acceptor's breakpoints
    kb = _take(bkps, (pos[..., None] - KMER_LEN + torch.arange(
        KMER_LEN + 1, device=dev)).clamp(0, L - 1))          # [B, M, 7]
    reps = kb.diff(dim=-1).clamp(1, MAX_KMER_SPAN)           # [B, M, 6]

    # context code of each covering k-mer (the rotated template)
    zt = (target - 1).clamp(0, 5)
    rel = _context_offsets(KMER_LEN, dev)                    # [6, 5]
    tpls = _base4(_take(zt, (pos[..., None, None] + rel).clamp(0, L - 1)
                        ).clamp(0, 3))                       # [B, M, 6]
    kup = torch.arange(KMER_LEN - 1, -1, -1, device=dev)     # [6]
    if tbl_fallback is not None:
        # sparse-library rescue: empty exact-context buckets redirect to
        # the deepest-suffix occupied bucket (identity when occupied)
        tpls = tbl_fallback[ub_idx, kup, tpls]

    # candidate selection per (stitch, k-mer): sample cand_sample_size from
    # the bucket, keep the closest in length to the local dwell span
    cnt = tbl_counts[ub_idx, kup, tpls]                      # [B, M, 6]
    cap = tbl_lens.shape[3]
    valid = torch.arange(cap, device=dev) < cnt[..., None]   # [B, M, 6, cap]
    r = torch.where(valid, torch.rand(valid.shape, generator=gen,
                                      device=dev), 1e9)
    order = r.argsort(-1)[..., :cand_sample_size]            # [B, M, 6, S]
    cl_full = tbl_lens[ub_idx, kup, tpls]                    # [B, M, 6, cap]
    diff = torch.where(valid.gather(-1, order),
                       (cl_full.gather(-1, order) - reps[..., None]).abs(),
                       10 ** 6)
    best = order.gather(-1, diff.argmin(-1, keepdim=True))   # [B, M, 6, 1]
    do_it = picked & (cnt > 0).all(-1)                       # [B, M]
    src_sig = tbl_signals[ub_idx, kup, tpls, best[..., 0]]   # [B, M, 6, K]
    src_len = cl_full.gather(-1, best)[..., 0]               # [B, M, 6]

    # compose each span: k-mer slices resampled to their dwell spans,
    # interpolated linearly within a k-mer only, never across a boundary
    # (the reference's per-k-mer linspace, stitch_chunks.py:247-261)
    offsets = torch.cat([reps.new_zeros(B, M, 1), reps.cumsum(-1)], -1)
    total = offsets[..., -1]                                 # [B, M]
    samp = torch.arange(MAX_SPAN, device=dev)
    which = (samp[:, None] >= offsets[:, :, None, 1:-1]).sum(-1).clamp(
        0, KMER_LEN - 1)                                     # [B, M, S]
    within = samp - offsets.gather(-1, which)
    len_g = src_len.gather(-1, which)
    # an integer product, then a true division in f32, as JAX computes it
    pos_f = (within * len_g) / reps.gather(-1, which).clamp(min=1)
    i0 = pos_f.floor().long().clamp(0, MAX_KMER_SPAN - 1)
    i1 = torch.minimum(i0 + 1, (len_g - 1).clamp(min=0))
    frac = (pos_f - i0).clamp(0.0, 1.0)
    flat = src_sig.flatten(2)                                # [B, M, 6 K]
    base = which * MAX_KMER_SPAN
    span_sig = (flat.gather(-1, base + i0) * (1.0 - frac)
                + flat.gather(-1, base + i1) * frac)         # [B, M, S]
    if permute_win_size:
        span_sig = _permute_transform(gen, span_sig, total, permute_win_size)
    span_sig = _noise_transform(gen, span_sig, noise_std, noise_mode)

    # one masked scatter for all spans, one for the targets
    write_len = torch.minimum(total, ins_en - ins_st)
    write = (samp < write_len[..., None]) & do_it[..., None]
    out_chunk = _put(chunks, ins_st[..., None] + samp, write, span_sig)
    out_target = _put(target, pos, do_it, spiked_ubs)
    return out_chunk, out_target.int(), do_it.any(-1)


_UB_CODE_MAP = {"X": (5,), "Y": (6,), "XY": (5, 6)}


def make_stitch_augment(xna_ctc_dir: str, ubs: str = "XY",
                        prop_ubs: float = 0.10, cand_sample_size: int = 5,
                        cap: int = 32, noise_std: float = 0.0,
                        noise_mode: str = "single",
                        tables: StitchTables | None = None,
                        weighted_pos_pick: bool = False,
                        weights_dir: str | None = None,
                        permute_win_size: int = 0, pad: int = 5,
                        relax: bool = False,
                        device: str | torch.device = "cuda"):
    """Build a ``ChunkDataset`` augment(chunks, targets, lengths,
    breakpoints, rng) -> (chunks, targets) closure that stitches on
    ``device``: numpy in, numpy out.

    ``xna_ctc_dir`` is sliced once here, like the reference's slice_xna
    pre-index (data.py:24-26), unless ``tables`` are given; the tables (and
    the relax map and the weight table) are uploaded once.  Raises
    ``ValueError`` when the tables hold no donor at all.  Each call seeds a
    generator on the device from ``rng`` as JAX seeds its key.
    """
    dev = resolve_device(device)
    if tables is None:
        tables = slice_xna_tables(xna_ctc_dir, cap=cap)
    if not tables.counts.any():
        raise ValueError(
            f"stitch: no donor in {xna_ctc_dir!r}: it holds no single-UB "
            "read with a natural 5-base context, so nothing can be spliced")
    sig, lens, counts = (torch.from_numpy(a).to(dev) for a in (
        tables.signals, tables.lens, tables.counts))
    ub_codes = _UB_CODE_MAP[ubs]
    fallback = None
    if relax:
        fallback = torch.from_numpy(
            build_relax_fallback(tables.counts)).long().to(dev)
    weight_table = None
    if weighted_pos_pick:
        weight_table = torch.from_numpy(load_kmer_weight_table(
            weights_dir or xna_ctc_dir)).to(dev)

    def augment(chunks, targets, lengths, breakpoints, rng):
        seed = int(rng.integers(0, 2 ** 31 - 1))
        gen = torch.Generator(device=dev).manual_seed(seed)
        c, t, _ = stitch_batch(
            gen, *_upload(dev, chunks, targets, lengths, breakpoints),
            sig, lens, counts,
            prop_ubs=prop_ubs, cand_sample_size=cand_sample_size,
            ub_codes=ub_codes, noise_std=noise_std, noise_mode=noise_mode,
            weight_table=weight_table, permute_win_size=permute_win_size,
            pad=pad, tbl_fallback=fallback)
        return c.cpu().numpy(), t.cpu().numpy()

    return augment


# ---------------------------------------------------------------------------
# k-mer-frequency-weighted insert position picking
# (reference load_kmers_weight + choose_positions_weighted,
#  stitch_chunks.py:26-102)

def count_kmers(ctc_dir: str, kmer_len: int = KMER_LEN,
                out_csv: bool = True):
    """Count natural 6-mers in a ctc-data directory's references and write
    ``kmer_count-len_6.csv`` (the artifact the reference expects,
    SURVEY §2.5).  Returns {kmer_code(base-4): count}."""
    _, targets, lengths = load_numpy_datasets(ctc_dir)[:3]
    counts = np.zeros(4 ** kmer_len, np.int64)
    pows = 4 ** np.arange(kmer_len - 1, -1, -1)
    for i in range(len(lengths)):
        t = np.asarray(targets[i, : int(lengths[i])], np.int64)
        valid = (t >= 1) & (t <= 4)
        z = t - 1
        for s in range(len(t) - kmer_len + 1):
            win = slice(s, s + kmer_len)
            if valid[win].all():
                counts[int((z[win] * pows).sum())] += 1
    if out_csv:
        path = os.path.join(ctc_dir, f"kmer_count-len_{kmer_len}.csv")
        with open(path, "w") as fh:
            fh.write("kmer,cnt\n")
            for code in np.nonzero(counts)[0]:
                kmer = ""
                c = int(code)
                for _ in range(kmer_len):
                    kmer = BASES[1 + c % 4] + kmer
                    c //= 4
                fh.write(f"{kmer},{counts[code]}\n")
    return counts


def load_kmer_weight_table(ctc_dir: str,
                           kmer_len: int = KMER_LEN) -> np.ndarray:
    """Balanced N-kmer weights as a dense [kmer_len, 4**(kmer_len-1)] table.

    Mirrors reference load_kmers_weight (stitch_chunks.py:26-44): each
    6-mer contributes its count to the 6 N-substituted variants; weight =
    (total / (n_groups * group_count)) ** 2.  Index: (N position within
    the k-mer, base-4 code of the 5 natural bases in order).
    """
    path = os.path.join(ctc_dir, f"kmer_count-len_{kmer_len}.csv")
    if not os.path.exists(path):
        count_kmers(ctc_dir, kmer_len)
    n_ctx = 4 ** (kmer_len - 1)
    sums = np.zeros((kmer_len, n_ctx), np.float64)
    with open(path) as fh:
        fh.readline()
        for line in fh:
            kmer, cnt = line.strip().split(",")
            cnt = float(cnt)
            codes = [CODE[c] - 1 for c in kmer]
            for p in range(kmer_len):
                ctx = 0
                for q, b in enumerate(codes):
                    if q == p:
                        continue
                    ctx = ctx * 4 + b
                sums[p, ctx] += cnt
    n_groups = (sums > 0).sum()
    total = sums.sum() / kmer_len  # each kmer counted once per N position
    with np.errstate(divide="ignore"):
        w = np.where(sums > 0, total * kmer_len / (n_groups * sums), 0.0)
    return (w ** 2).astype(np.float32)


def position_weights(target, length, weight_table,
                     kmer_len: int = KMER_LEN):
    """Per-position insert weights [B, L] for target [B, L], length [B]:
    the geometric mean of the 6 N-kmer weights covering each position
    (stitch_chunks.py:53-73); 0 at edges and where any covering k-mer
    leaves the natural alphabet."""
    L = target.shape[1]
    dev = target.device
    zt = (target - 1).clamp(0, 5)
    natural = (target >= 1) & (target <= 4)
    pos_idx = torch.arange(L, device=dev)

    log_w_sum = torch.zeros(target.shape, device=dev)
    ok = torch.ones(target.shape, dtype=torch.bool, device=dev)
    for kmer_idx in range(kmer_len):
        # the k-mer covering pos with N at kmer_ub_pos = kmer_len-1-kmer_idx
        kup = kmer_len - 1 - kmer_idx
        offs = torch.tensor([j - kup for j in range(kmer_len) if j != kup],
                            device=dev)
        p = pos_idx + offs[:, None]                          # [k-1, L]
        pc = p.clamp(0, L - 1)
        ctx = _base4(zt[:, pc].clamp(0, 3).transpose(-1, -2))   # [B, L]
        good = (natural[:, pc] & (p >= 0) & (p < length[:, None, None])
                ).all(1)
        w = weight_table[kup][ctx]
        ok = ok & good & (w > 0)
        log_w_sum = log_w_sum + torch.log(torch.clamp(w, min=1e-30))
    # a 0-dim divisor: the card divides by a Python number as a product with
    # its reciprocal
    weights = torch.exp(log_w_sum / torch.full((), float(kmer_len),
                                               device=dev))
    in_range = ((pos_idx >= kmer_len - 1)
                & (pos_idx < length[:, None] - kmer_len + 1))
    return torch.where(ok & in_range, weights, 0.0)
