"""95th percentile of the window's per-update times (host clock, staging
included); None below 200 updates, where fewer than ten lie beyond it."""

import statistics


def read(rec):
    each = rec["solve_s"]
    if len(each) < 200:
        return None
    return 1e3 * statistics.quantiles(each, n=20)[18]
