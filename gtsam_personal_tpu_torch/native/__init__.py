"""ctypes bindings for the native symbolic-analysis library.

JAX counterpart: gtsam_personal_tpu/native/__init__.py and
native/symbolic.cpp, of which this package keeps its own copy. `symbolic.cpp`
is compiled at first use (g++ -O3 -shared) into `build/native/` at the root
of the checkout, under a name keyed by a hash of the source, never beside
the source. Every entry point has a numpy version (`*_np`) that is taken
where there is no g++, so the package works without a compiler (a g++ that
fails on the source raises instead); these run on the host, touch no device
and stand for no kernel. With the library, the host-side symbolic phase (BFS partitioning, orderings, factor
classification) runs at C++ speed.

The numpy orderings are simpler algorithms than the native ones (greedy
minimum degree without the clique update), as in the JAX package: they give
a valid ordering, not the same one.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "symbolic.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libgtsam_torch_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run(["g++", *_GXX_FLAGS, str(_SRC), "-o", tmp],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC.name} (exit "
                               f"{done.returncode}):\n{done.stderr}")
        os.replace(tmp, out)        # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def get_lib():
    """The built library with its argtypes set, or None where there is
    neither a built library nor a g++ to build one: callers then take the
    numpy versions. A g++ that is present and fails raises with its
    messages, so that a broken source does not pass for a missing compiler
    (the numpy orderings give another permutation)."""
    if not library_path().exists() and shutil.which("g++") is None:
        return None
    lib = ctypes.CDLL(str(_build()))
    I64 = ctypes.POINTER(ctypes.c_int64)
    U8 = ctypes.POINTER(ctypes.c_uint8)
    lib.bfs_levels.restype = ctypes.c_int64
    lib.bfs_levels.argtypes = [ctypes.c_int64, I64, I64, U8, ctypes.c_int64,
                               I64]
    lib.min_degree_order.restype = None
    lib.min_degree_order.argtypes = [ctypes.c_int64, I64, I64, I64]
    lib.min_degree_order_grouped.restype = None
    lib.min_degree_order_grouped.argtypes = [ctypes.c_int64, I64, I64, I64,
                                             I64]
    lib.classify_factors.restype = ctypes.c_int64
    lib.classify_factors.argtypes = [ctypes.c_int64, ctypes.c_int64, I64,
                                     I64, I64]
    return lib


def _ptr(a, typ=ctypes.c_int64):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _check_csr(indptr, indices, n):
    """The C code indexes without bounds checks: refuse a CSR structure that
    would read outside its arrays."""
    if n < 0 or indptr[0] != 0 or indptr[-1] != len(indices) \
            or np.any(np.diff(indptr) < 0):
        raise ValueError("indptr is not a CSR row pointer of indices")
    if len(indices) and (indices.min() < 0 or indices.max() >= n):
        raise ValueError("a CSR column index is out of range")


def bfs_levels_np(indptr, indices, mask, start):
    n = len(indptr) - 1
    level = np.full(n, -1, dtype=np.int64)
    if not mask[start]:
        return level
    level[start] = 0
    frontier = np.array([start])
    lv = 0
    while frontier.size:
        lv += 1
        nxt = []
        for u in frontier:
            nbr = indices[indptr[u]:indptr[u + 1]]
            nbr = nbr[mask[nbr] & (level[nbr] < 0)]
            level[nbr] = lv
            nxt.append(nbr)
        frontier = np.unique(np.concatenate(nxt))
    return level


def bfs_levels(indptr, indices, mask, start):
    """BFS levels over the masked CSR subgraph; -1 for unreached."""
    lib = get_lib()
    if not lib:
        return bfs_levels_np(indptr, indices, np.asarray(mask, dtype=bool),
                             start)
    n = len(indptr) - 1
    indptr, indices = _i64(indptr), _i64(indices)
    _check_csr(indptr, indices, n)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    if len(m) != n or not 0 <= int(start) < n:
        raise ValueError("mask must have one entry per node and start must "
                         "be a node")
    level = np.empty(n, dtype=np.int64)
    lib.bfs_levels(n, _ptr(indptr), _ptr(indices), _ptr(m, ctypes.c_uint8),
                   int(start), _ptr(level))
    return level


def _greedy_order_np(indptr, indices, group):
    """Greedy (group, degree) selection without the clique update."""
    n = len(indptr) - 1
    perm = np.empty(n, dtype=np.int64)
    deg = np.diff(indptr).astype(np.int64)
    alive = np.ones(n, dtype=bool)
    big = np.iinfo(np.int64).max // 4
    for k in range(n):
        u = int(np.argmin(np.where(alive, group * big + deg,
                                   np.iinfo(np.int64).max)))
        perm[k] = u
        alive[u] = False
        nbr = indices[indptr[u]:indptr[u + 1]]
        deg[nbr[alive[nbr]]] -= 1
    return perm


def min_degree_order_np(indptr, indices):
    return _greedy_order_np(indptr, indices,
                            np.zeros(len(indptr) - 1, dtype=np.int64))


def min_degree_order(indptr, indices):
    """Fill-reducing minimum-degree elimination ordering (the COLAMD
    analogue); perm[k] is the k-th variable to eliminate."""
    lib = get_lib()
    if not lib:
        return min_degree_order_np(indptr, indices)
    n = len(indptr) - 1
    indptr, indices = _i64(indptr), _i64(indices)
    _check_csr(indptr, indices, n)
    perm = np.empty(n, dtype=np.int64)
    lib.min_degree_order(n, _ptr(indptr), _ptr(indices), _ptr(perm))
    return perm


def min_degree_order_grouped_np(indptr, indices, group):
    return _greedy_order_np(indptr, indices, _i64(group))


def min_degree_order_grouped(indptr, indices, group):
    """Group-constrained minimum degree: all group-g vertices are eliminated
    before any group-(g+1) vertex, fill-reducing within a group (reference:
    Ordering::ColamdConstrainedLast/First, inference/Ordering.h:112-139)."""
    lib = get_lib()
    if not lib:
        return min_degree_order_grouped_np(indptr, indices, group)
    n = len(indptr) - 1
    indptr, indices, group = _i64(indptr), _i64(indices), _i64(group)
    _check_csr(indptr, indices, n)
    if len(group) != n:
        raise ValueError("group must have one entry per node")
    perm = np.empty(n, dtype=np.int64)
    lib.min_degree_order_grouped(n, _ptr(indptr), _ptr(indices), _ptr(group),
                                 _ptr(perm))
    return perm


def classify_factors_np(vids, part_of):
    parts = part_of[vids]
    fpart = parts.max(axis=1)
    mn = np.where(parts < 0, fpart[:, None], parts).min(axis=1)
    if not np.all((mn == fpart) | (fpart < 0)):
        raise ValueError("factor spans two interior parts")
    return fpart


def classify_factors(vids, part_of):
    """Per-factor interior part ids ([K] from vids [K, S]; -1 where every
    slot is a separator variable); raises if a factor spans two interiors."""
    vids, part_of = _i64(vids), _i64(part_of)
    if vids.size and (vids.min() < 0 or vids.max() >= len(part_of)):
        raise ValueError("a variable id is out of range of part_of")
    lib = get_lib()
    if not lib:
        return classify_factors_np(vids, part_of)
    K, S = vids.shape
    fpart = np.empty(K, dtype=np.int64)
    bad = lib.classify_factors(K, S, _ptr(vids), _ptr(part_of), _ptr(fpart))
    if bad:
        raise ValueError(f"factor {bad - 1} spans two interior parts")
    return fpart
