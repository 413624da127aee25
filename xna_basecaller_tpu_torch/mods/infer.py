"""Modified-base inference: motif screening, feature extraction, MM/ML tags.

Port of ``xna_basecaller_tpu/mods/infer.py``: ``find_motif_sites``,
``seq_to_sig_map``, ``extract_features``, ``mods_tags_to_str`` and
``mm_ml_tags`` are numpy copies of JAX's; ``call_mods`` scores every
site of a read in batches through the classifier on its device (the
reference's remora hook surface, mod_util.py:64-87: the basecall attrs
carry the per-frame move table, whose moves x stride give the
sequence-to-signal map, and the results land in ``read_attrs['mods']`` as
SAM MM/ML tag strings, SAMtags spec 1.7).
"""

from __future__ import annotations

import numpy as np
import torch

from xna_basecaller_tpu_torch.mods.model import (
    ALPHABET, ModsConfig, mods_forward,
)

_CODE = {c: i for i, c in enumerate(ALPHABET)}


def find_motif_sites(seq: str, motif: str, offset: int) -> np.ndarray:
    """Positions of the modifiable base for every motif occurrence."""
    sites = []
    start = seq.find(motif)
    while start >= 0:
        sites.append(start + offset)
        start = seq.find(motif, start + 1)
    return np.asarray(sites, dtype=np.int64)


def seq_to_sig_map(moves: np.ndarray, stride: int,
                   sig_len: int) -> np.ndarray:
    """Move table -> signal index where each base's event starts, plus a
    final entry at sig_len (remora's seq_to_sig_map contract,
    reference mod_util.py:70-75)."""
    starts = np.flatnonzero(np.asarray(moves)) * stride
    return np.concatenate([starts, [sig_len]]).astype(np.int64)


def extract_features(signal: np.ndarray, seq: str, moves: np.ndarray,
                     stride: int, sites: np.ndarray, cfg: ModsConfig):
    """Per-site fixed windows: raw signal centred on the base's event and
    the surrounding sequence codes.  Returns (sig [S, W], ctx [S, C])."""
    sig = np.asarray(signal, np.float32)
    s2s = seq_to_sig_map(moves, stride, len(sig))
    W, C = cfg.sig_window, 2 * cfg.context + 1
    out_sig = np.zeros((len(sites), W), np.float32)
    out_ctx = np.zeros((len(sites), C), np.int32)
    codes = np.array([_CODE.get(c, 0) for c in seq], np.int32)
    padded = np.zeros(len(codes) + 2 * cfg.context, np.int32)
    padded[cfg.context: cfg.context + len(codes)] = codes
    for i, pos in enumerate(sites):
        centre = (s2s[pos] + s2s[pos + 1]) // 2
        lo = int(centre) - W // 2
        a, b = max(lo, 0), min(lo + W, len(sig))
        out_sig[i, a - lo: b - lo] = sig[a:b]
        out_ctx[i] = padded[pos: pos + C]
    return out_sig, out_ctx


def mods_tags_to_str(mods_tags) -> list[str]:
    """(MM body, ML byte list) -> SAM tag strings (mod_util.py:57-61)."""
    return [
        f"MM:Z:{mods_tags[0]}",
        f"ML:B:C,{','.join(map(str, mods_tags[1]))}",
    ]


def mm_ml_tags(seq: str, sites: np.ndarray, probs: np.ndarray,
               cfg: ModsConfig) -> tuple[str, list[int]]:
    """Build the MM delta string + ML probability bytes for all scored
    sites ('call-all' mode: every motif site is reported with its
    probability, the '?' skip scheme)."""
    canonical_pos = np.asarray(
        [i for i, c in enumerate(seq) if c == cfg.canonical], np.int64)
    rank = {int(p): r for r, p in enumerate(canonical_pos)}
    deltas = []
    prev_rank = -1
    for pos in sites:
        r = rank[int(pos)]
        deltas.append(r - prev_rank - 1)
        prev_rank = r
    mm = (f"{cfg.canonical}+{cfg.mod_code}?,"
          + ",".join(str(d) for d in deltas) + ";")
    ml = [int(np.clip(np.floor(p * 256.0), 0, 255)) for p in probs]
    return mm, ml


def site_probs(model, sig_w: np.ndarray, ctx: np.ndarray,
               batch: int = 2048) -> np.ndarray:
    """Each site's modification probability (sigmoid of the logit), in
    batches of ``batch`` sites through the classifier on its device."""
    probs = np.empty(len(sig_w), np.float32)
    with torch.inference_mode():
        for i in range(0, len(sig_w), batch):
            logits = mods_forward(model, sig_w[i: i + batch],
                                  ctx[i: i + batch])
            probs[i: i + batch] = torch.sigmoid(logits).cpu().numpy()
    return probs


def call_mods(mods_model, read, read_attrs: dict,
              batch: int = 2048) -> dict:
    """Score every motif site in the basecall and attach MM/ML tags
    (same contract as reference mod_util.py:64-87; no-op on empty
    sequences or motif-free reads).  ``mods_model`` is (cfg, ModsModel),
    as ``load_mods_model`` returns it."""
    seq = read_attrs.get("sequence", "")
    if not seq:
        return read_attrs
    cfg, model = mods_model
    sites = find_motif_sites(seq, cfg.motif, cfg.motif_offset)
    if not len(sites):
        return read_attrs
    sig_w, ctx = extract_features(
        read.signal, seq, read_attrs["moves"], read_attrs["stride"],
        sites, cfg)
    probs = site_probs(model, sig_w, ctx, batch)
    read_attrs["mods"] = mods_tags_to_str(mm_ml_tags(seq, sites, probs, cfg))
    return read_attrs
