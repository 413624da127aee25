"""Copied from ``xna_basecaller_tpu/utils/poa.py``; only the package
imports differ.

Partial-order-alignment consensus.

Replaces the reference's GPU POA stacks — `claragenomics.cudapoa` in
`ub-bonito/bonito/util.py:440-465` / `cli/duplex.py:43-97` and the `spoa`
import in duplex — with a host-native implementation: the C++ kernel in
`native/xna_native.cpp::poa_consensus` (graph POA, spoa-like 5/-4/-8
scores, heaviest-bundle consensus), with the same algorithm in pure
python as the no-toolchain fallback.

POA is a host-side, tiny-group, ragged-string problem — the wrong shape
for the MXU — so unlike the model it stays off-device by design.
"""

from __future__ import annotations

from xna_basecaller_tpu_torch.utils import native

_PM, _PX, _PG = 5, -4, -8  # match / mismatch / linear gap (spoa defaults)


def poa(groups: list[list[str]], max_poa_sequences: int = 100) -> list[str]:
    """Generate a consensus for each group of sequences.

    Same signature/semantics as the reference `util.py::poa` (the
    `gpu_mem_per_batch` knob is meaningless here and dropped); groups
    larger than `max_poa_sequences` use the first `max_poa_sequences`
    members, matching CudaPoaBatch's capacity cap.
    """
    out = []
    for group in groups:
        group = [s for s in group if s][:max_poa_sequences]
        out.append(consensus(group))
    return out


def consensus(seqs: list[str]) -> str:
    """POA consensus of one group (native first, python fallback)."""
    seqs = [s for s in seqs if s]
    if not seqs:
        return ""
    if len(seqs) == 1:
        return seqs[0]
    result = native.poa_consensus(seqs)
    if result is not None:
        return result
    return _consensus_py(seqs)


def _consensus_py(seqs: list[str]) -> str:
    """Pure-python POA (the oracle the native kernel is tested against)."""
    # graph: per-node base, preds {pred_id: weight}, aligned-variant ids
    base, preds, aln = [], [], []
    for i, ch in enumerate(seqs[0]):
        base.append(ch)
        preds.append({i - 1: 1} if i > 0 else {})
        aln.append([])

    for s in seqs[1:]:
        if not s:
            continue
        walk = _align_to_graph(base, preds, s)
        prev = -1
        for node, pos in walk:
            if pos < 0:
                continue
            ch = s[pos]
            cur = -1
            if node >= 0 and base[node] == ch:
                cur = node
            elif node >= 0:
                for a in aln[node]:
                    if base[a] == ch:
                        cur = a
                        break
            if cur < 0:
                cur = len(base)
                base.append(ch)
                preds.append({})
                group = (aln[node] + [node]) if node >= 0 else []
                aln.append(list(group))
                for a in group:
                    aln[a].append(cur)
            if prev >= 0 and prev != cur:
                preds[cur][prev] = preds[cur].get(prev, 0) + 1
            prev = cur

    # heaviest-bundle consensus over a fresh topo order
    order = _topo_order(preds)
    score = {v: 0 for v in order}
    came = {v: -1 for v in order}
    best_v, best_s = order[0], -1
    for v in order:
        for p, w in preds[v].items():
            if score[p] + w > score[v]:
                score[v] = score[p] + w
                came[v] = p
        if score[v] > best_s:
            best_s, best_v = score[v], v
    out = []
    v = best_v
    while v >= 0:
        out.append(base[v])
        v = came[v]
    return "".join(reversed(out))


def _topo_order(preds: list[dict[int, int]]) -> list[int]:
    n = len(preds)
    succ = [[] for _ in range(n)]
    in_deg = [0] * n
    for v in range(n):
        for p in preds[v]:
            succ[p].append(v)
            in_deg[v] += 1
    order = [v for v in range(n) if in_deg[v] == 0]
    for v in order:  # grows while iterating
        for w in succ[v]:
            in_deg[w] -= 1
            if in_deg[w] == 0:
                order.append(w)
    return order


def _align_to_graph(base: list[str], preds: list[dict[int, int]], s: str):
    """NW of sequence `s` against the DAG; returns [(node|-1, pos|-1)]."""
    NEG = -(10 ** 9)
    order = _topo_order(preds)
    rank = {node: r + 1 for r, node in enumerate(order)}
    V, L = len(order), len(s)
    W = L + 1
    H = [[0] * W for _ in range(V + 1)]
    TB = [[2] * W for _ in range(V + 1)]
    TP = [[-1] * W for _ in range(V + 1)]
    for j in range(W):
        H[0][j] = j * _PG
    for r in range(1, V + 1):
        node = order[r - 1]
        prs = list(preds[node]) or [-1]
        for j in range(W):
            best, bt, bp = NEG, 2, -1
            if j > 0:
                best = H[r][j - 1] + _PG
            m = (_PM if base[node] == s[j - 1] else _PX) if j > 0 else 0
            for p in prs:
                pr = 0 if p < 0 else rank[p]
                if j > 0 and H[pr][j - 1] + m > best:
                    best, bt, bp = H[pr][j - 1] + m, 0, p
                if H[pr][j] + _PG > best:
                    best, bt, bp = H[pr][j] + _PG, 1, p
            H[r][j], TB[r][j], TP[r][j] = best, bt, bp
    er = max(range(1, V + 1), key=lambda r: H[r][L])
    walk = []
    r, j = er, L
    while j > 0 or r > 0:
        if r == 0:
            walk.append((-1, j - 1))
            j -= 1
            continue
        t = TB[r][j]
        if t == 0:
            walk.append((order[r - 1], j - 1))
            p = TP[r][j]
            r = 0 if p < 0 else rank[p]
            j -= 1
        elif t == 1:
            walk.append((order[r - 1], -1))
            p = TP[r][j]
            r = 0 if p < 0 else rank[p]
        else:
            walk.append((-1, j - 1))
            j -= 1
    walk.reverse()
    return walk
