"""Median ms of one linear.linearize.linearize(graph, values) call at the
values the window left (host clock between synchronizes)."""

import statistics


def read(rec):
    ms = rec.get("spans", {}).get("pose_linearize_ms")
    return statistics.median(ms) if ms else None
