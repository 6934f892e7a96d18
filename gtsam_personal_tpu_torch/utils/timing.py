"""Hierarchical tic/toc profiler.

Reference parity: gtsam/base/timing.h (gttic/gttoc + TimingOutline tree):
RAII-scoped sections auto-nest into a global tree keyed by call structure;
`print_timing()` dumps the tree. Device work is made visible by an optional
synchronization on section exit.

JAX counterpart: gtsam_personal_tpu/utils/timing.py (all of it). `sync`
takes the tensors of the section (or a device); on exit the section waits
for the CUDA card they live on (`torch.cuda.synchronize`), where the JAX
package blocks on its arrays.
"""

import time
from contextlib import contextmanager
from typing import Dict

import torch


class _Node:
    __slots__ = ("label", "total", "count", "children")

    def __init__(self, label):
        self.label = label
        self.total = 0.0
        self.count = 0
        self.children: Dict[str, "_Node"] = {}


_root = _Node("root")
_stack = [_root]


def _devices(x):
    if isinstance(x, torch.Tensor):
        yield x.device
    elif isinstance(x, torch.device):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _devices(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _devices(v)


def _synchronize(sync):
    for dev in {d for d in _devices(sync) if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextmanager
def tic(label: str, sync=None):
    """Scoped timing section (gttic/gttoc analogue).

    sync: optional tensor, sequence or dict of tensors, or device: on
    exit, wait for the CUDA card where they live, so that device time is
    attributed to this section. CPU tensors need no wait."""
    parent = _stack[-1]
    node = parent.children.setdefault(label, _Node(label))
    _stack.append(node)
    t0 = time.perf_counter()
    try:
        yield node
    finally:
        if sync is not None:
            _synchronize(sync)
        node.total += time.perf_counter() - t0
        node.count += 1
        _stack.pop()


def reset():
    global _root, _stack
    _root = _Node("root")
    _stack = [_root]


def report() -> str:
    """Format the timing tree (tictoc_print_ analogue)."""
    lines = []

    def walk(node, depth):
        for label, child in node.children.items():
            lines.append("%s%-30s %8.3f s  (%d calls, %.4f s/call)" % (
                "  " * depth, label, child.total, child.count,
                child.total / max(child.count, 1)))
            walk(child, depth + 1)

    walk(_root, 0)
    return "\n".join(lines)


def print_timing():
    print(report())
