"""Host-side graph partitioning: nested-dissection-style vertex separators.

JAX counterpart: gtsam_personal_tpu/inference/partition.py (all of it). The
reference orders elimination with COLAMD/METIS (inference/Ordering.h:93-188)
and keeps a pointer-based elimination tree. This design instead partitions
the variable graph into p independent interior blocks plus a vertex
separator: the interiors eliminate as one batched dense operation, and the
separator forms the reduced system. The same structure is the multi-device
sharding layout (each part -> a device).

Partitioning is recursive BFS level-structure bisection (a lightweight
stand-in for METIS nested dissection, adequate for SLAM/SfM graphs). It runs
once per graph structure on the host in numpy/scipy; a graph's index tensors
are copied to the host for it, wherever they live.
"""

from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from gtsam_personal_tpu_torch import native
from gtsam_personal_tpu_torch.core import manifolds


class VarIndex:
    """Flatten (group, index) variables to contiguous ints (host-side)."""

    def __init__(self, counts: Dict[str, int]):
        self.groups = sorted(counts)
        self.counts = dict(counts)
        self.offsets = {}
        off = 0
        for g in self.groups:
            self.offsets[g] = off
            off += counts[g]
        self.num_vars = off
        self.dims = np.zeros(off, dtype=np.int64)
        self.group_of = np.empty(off, dtype=object)
        self.index_of = np.zeros(off, dtype=np.int64)
        for g in self.groups:
            d = manifolds.get(g).dim
            o, n = self.offsets[g], counts[g]
            self.dims[o:o + n] = d
            self.group_of[o:o + n] = g
            self.index_of[o:o + n] = np.arange(n)

    def vid(self, group: str, idx):
        return self.offsets[group] + np.asarray(idx)


def batch_vids(batch, vi: VarIndex) -> np.ndarray:
    """Flat variable ids [K, nslots] of a factor batch, on the host."""
    idx = batch.idx.detach().cpu().numpy()
    return np.stack([vi.vid(g, idx[:, s])
                     for s, g in enumerate(batch.groups)], axis=1)


def build_adjacency(graph, counts: Dict[str, int]) -> Tuple[VarIndex, sp.csr_matrix]:
    """Variable adjacency from factor connectivity (host, numpy)."""
    vi = VarIndex(counts)
    rows, cols = [], []
    for b in graph.batches:
        ids = batch_vids(b, vi)
        for s in range(ids.shape[1]):
            for t in range(s + 1, ids.shape[1]):
                rows.append(ids[:, s])
                cols.append(ids[:, t])
    n = vi.num_vars
    if rows:
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        data = np.ones(len(r), dtype=np.int8)
        A = sp.coo_matrix((data, (r, c)), shape=(n, n))
        A = (A + A.T).tocsr()
        A.data[:] = 1
    else:
        A = sp.csr_matrix((n, n), dtype=np.int8)
    return vi, A


def _bfs_levels(A: sp.csr_matrix, mask: np.ndarray, start: int) -> np.ndarray:
    """BFS level of each node within the masked subgraph (-1 outside/unreached).

    Dispatches to the native C++ traversal (native/symbolic.cpp)."""
    return native.bfs_levels(A.indptr.astype(np.int64),
                             A.indices.astype(np.int64), mask, start)


def _pseudo_peripheral(A, mask, seed):
    """Double-BFS heuristic for a far-apart start node."""
    lv = _bfs_levels(A, mask, seed)
    reach = np.where((lv >= 0) & mask)[0]
    far = reach[np.argmax(lv[reach])]
    return far


def bisect(A: sp.csr_matrix, nodes: np.ndarray, band=(0.25, 0.75)):
    """Split `nodes` into (partA, partB, separator) by BFS level structure.

    Cut selection: the NARROWEST frontier level within the middle balance
    band (balance-penalized), rather than the median level — on
    loop-closure-heavy graphs this finds waists and shrinks the total
    separator substantially (city10000: 2386 -> 1664 separator vertices,
    -30%). The level-ℓ* vertex set separates {<ℓ*} from {>ℓ*}; separator
    vertices with no neighbor on the A side are refined back into B."""
    mask = np.zeros(A.shape[0], dtype=bool)
    mask[nodes] = True
    start = _pseudo_peripheral(A, mask, nodes[0])
    lv = _bfs_levels(A, mask, start)
    reach = nodes[lv[nodes] >= 0]
    unreached = nodes[lv[nodes] < 0]  # disconnected components -> side A
    if reach.size == 0:
        return nodes, np.array([], dtype=np.int64), np.array([], dtype=np.int64)
    levels = lv[reach]
    Lmax = int(levels.max())
    cnt = np.bincount(levels, minlength=Lmax + 1)
    cum = np.cumsum(cnt)
    n = reach.size
    best, best_score = None, np.inf
    for level in range(Lmax + 1):
        frac = cum[level] / n
        if frac < band[0] or frac > band[1]:
            continue
        score = cnt[level] * (1.0 + 2.0 * abs(frac - 0.5))
        if score < best_score:
            best_score, best = score, level
    if best is None:
        best = int(np.median(levels))
    sideA = reach[levels < best]
    sep = reach[levels == best]
    sideB = reach[levels > best]
    if sideA.size == 0 and sideB.size == 0:
        # single-level degenerate: split arbitrarily in half; the separator
        # is then the B-side vertices adjacent to A (full edge cover)
        h = reach.size // 2
        sideA, rest = reach[:h], reach[h:]
        inA_ = np.zeros(A.shape[0], dtype=bool)
        inA_[sideA] = True
        adjA = np.zeros(rest.size, dtype=bool)
        for t, u in enumerate(rest):
            nbr = A.indices[A.indptr[u]:A.indptr[u + 1]]
            adjA[t] = bool(np.any(inA_[nbr]))
        sep, sideB = rest[adjA], rest[~adjA]
    # refine: separator vertices with no neighbor in A belong in B
    inA = np.zeros(A.shape[0], dtype=bool)
    inA[sideA] = True
    indptr, indices = A.indptr, A.indices
    keep_mask = np.zeros(sep.size, dtype=bool)
    for t, u in enumerate(sep):
        nbr = indices[indptr[u]:indptr[u + 1]]
        keep_mask[t] = bool(np.any(inA[nbr]))
    sideB = np.concatenate([sideB, sep[~keep_mask]])
    sep = sep[keep_mask]
    sideA = np.concatenate([sideA, unreached])
    return sideA, sideB, sep


class Partition:
    """p interior parts + global separator (two-level nested dissection)."""

    def __init__(self, parts: List[np.ndarray], separator: np.ndarray, vi: VarIndex):
        self.parts = parts
        self.separator = separator
        self.vi = vi
        self.part_of = np.full(vi.num_vars, -1, dtype=np.int64)  # -1 = separator
        for k, p in enumerate(parts):
            self.part_of[p] = k

    @property
    def num_parts(self):
        return len(self.parts)

    def stats(self):
        sizes = [p.size for p in self.parts]
        return {"parts": len(self.parts), "max_part": max(sizes) if sizes else 0,
                "min_part": min(sizes) if sizes else 0, "separator": self.separator.size}


def partition_nodes(A: sp.csr_matrix, nodes, max_part_size: int):
    """Recursive bisection of `nodes` until every part has at most
    max_part_size of them: (sorted parts, the sorted union of every
    level's separators)."""
    parts: List[np.ndarray] = []
    seps: List[np.ndarray] = []
    stack = [np.asarray(nodes, dtype=np.int64)]
    while stack:
        nodes = stack.pop()
        if nodes.size == 0:
            continue
        if nodes.size <= max_part_size:
            parts.append(np.sort(nodes))
            continue
        a, b, s = bisect(A, nodes)
        if s.size == 0 and (a.size == 0 or b.size == 0):
            # could not split (clique-ish); accept as one part
            parts.append(np.sort(nodes))
            continue
        seps.append(s)
        stack.append(a)
        stack.append(b)
    separator = np.sort(np.concatenate(seps)) if seps else np.array([], dtype=np.int64)
    return parts, separator


def partition_graph(graph, counts: Dict[str, int], max_part_size: int = 256) -> Partition:
    """Recursively bisect until every interior part <= max_part_size.

    All separator vertices (from every level) join one global separator —
    a two-level elimination structure: batched interior elimination, then a
    single reduced separator solve."""
    vi, A = build_adjacency(graph, counts)
    parts, separator = partition_nodes(A, np.arange(vi.num_vars),
                                       max_part_size)
    return Partition(parts, separator, vi)
