"""Disjoint-set forest (union-find) and feature-track generation.

JAX counterpart: gtsam_personal_tpu/core/dsf.py (all of it; reference:
gtsam/base/DSFMap.h / DSFVector, gtsam/sfm/DsfTrackGenerator.h and
base/kruskal.h): merge pairwise feature matches into multi-view tracks, and
the spanning forest of linear/subgraph.py. Host-side Python and numpy, run
when a dataset or a preconditioner's structure is built.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np


class DSF:
    """Union-find with path compression and union by rank."""

    def __init__(self, n: int = 0):
        self.parent = list(range(n))
        self.rank = [0] * n

    def add(self) -> int:
        self.parent.append(len(self.parent))
        self.rank.append(0)
        return len(self.parent) - 1

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1

    def sets(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for i in range(len(self.parent)):
            out.setdefault(self.find(i), []).append(i)
        return out


def generate_tracks(matches: Sequence[Tuple[Tuple[int, int],
                                            Tuple[int, int]]],
                    measurements: Dict[Tuple[int, int], np.ndarray]):
    """Merge pairwise matches ((cam_i, feat_i), (cam_j, feat_j)) into tracks
    (reference: DsfTrackGenerator): a list of tracks, each a list of
    (camera, measurement) pairs. A track that sees one camera twice is an
    inconsistent merge and is dropped, as the reference filters it."""
    keys: Dict[Tuple[int, int], int] = {}
    dsf = DSF()

    def key_id(k):
        if k not in keys:
            keys[k] = dsf.add()
        return keys[k]

    for a, b in matches:
        dsf.union(key_id(a), key_id(b))

    inv = {v: k for k, v in keys.items()}
    tracks = []
    for members in dsf.sets().values():
        if len(members) < 2:
            continue
        obs = [inv[m] for m in members]
        cams = [c for c, _ in obs]
        if len(set(cams)) != len(cams):
            continue
        tracks.append([(c, measurements[(c, f)]) for c, f in sorted(obs)])
    return tracks


def kruskal_mst(n: int, edges: Sequence[Tuple[int, int]],
                weights: Sequence[float]) -> List[int]:
    """Indices of the edges of a maximum-weight spanning forest (reference:
    base/kruskal.h, used by the subgraph preconditioner)."""
    order = np.argsort(-np.asarray(weights, dtype=np.float64))
    dsf = DSF(n)
    chosen = []
    for k in order:
        i, j = edges[k]
        if dsf.find(i) != dsf.find(j):
            dsf.union(i, j)
            chosen.append(int(k))
    return chosen
