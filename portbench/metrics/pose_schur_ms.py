"""Median ms of one linear.schur.solve_partitioned(lin, plan, lam) call at
the window's last linearization and lambda (host clock between
synchronizes)."""

import statistics


def read(rec):
    ms = rec.get("spans", {}).get("pose_schur_ms")
    return statistics.median(ms) if ms else None
