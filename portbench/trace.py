"""A profiled stretch of a run, reduced to what the metrics read.

`profile(fn)` runs fn() under torch.profiler (host and device activity),
writes the Chrome trace to a temporary directory, reads it back and removes
it. From the trace:
  - busy_s: the union of the device's intervals (kernels, copies, fills)
    inside the stretch, on every stream;
  - window_s: the stretch's length (its `portbench.stretch` annotation);
  - kernels: {name: [launches, device seconds]} of every device event;
  - device_ops: the ten names with the most device time;
  - idle_gaps: the device's idle time inside the stretch, summed by what the
    host was doing at each gap's middle (the innermost host operator there,
    or "host (no operator)"), the ten largest.
"""

import json
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile as _profile

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}
STRETCH = "portbench.stretch"
# a breakdown's names are cut to this many characters (kernels' template
# arguments run to thousands)
NAME_CHARS = 160
# the profiler's own bookkeeping, which it reports as device activity
NOT_WORK = {"Buffer Flush", "Activity Buffer Request"}


class Trace(NamedTuple):
    busy_s: float
    window_s: float
    kernels: dict
    device_ops: list
    idle_gaps: list


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events):
    """Trace of a list of Chrome trace events (ts and dur in microseconds)."""
    stretch = [e for e in events if e.get("name") == STRETCH
               and e.get("cat") == "user_annotation"]
    if not stretch:
        raise RuntimeError("the trace holds no portbench.stretch annotation")
    lo = stretch[0]["ts"]
    hi = lo + stretch[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS and e.get("name") not in NOT_WORK]
    kernels = {}
    for e in dev:
        k = kernels.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += e["dur"] * 1e-6
    busy = _union((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                  for e in dev if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    tid = stretch[0].get("tid")
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("tid") == tid and e.get("name") != STRETCH)
    gaps = {}
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    stack, k = [], 0            # host operators open at the sweep's point
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host (no operator)"
        gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return Trace(sum(e - s for s, e in busy) * 1e-6, (hi - lo) * 1e-6,
                 kernels, [[n[:NAME_CHARS], v[1]] for n, v in top],
                 sorted(([n, s] for n, s in gaps.items()),
                        key=lambda g: -g[1])[:10])


def profile(fn, device):
    """(fn's result, Trace) of one call of fn() under the profiler."""
    acts = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with _profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return out, reduce(events)


def kernel(t: Trace, name):
    """(launches, mean device seconds) of the kernels whose name contains
    `name`, or None if the trace holds none."""
    hits = [v for k, v in t.kernels.items() if name in k]
    n = sum(h[0] for h in hits)
    return (n, sum(h[1] for h in hits) / n) if n else None


def idle_share(rec):
    """Percent of the traced stretch in which the device ran nothing."""
    t = rec.get("trace")
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
