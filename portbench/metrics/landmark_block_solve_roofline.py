"""Percent of its roofline that the landmark_block_solve kernel reaches:
the least time of one call at the cell's P and dtype (roofline.py) over its
mean device time in the traced stretch."""

from portbench import roofline, trace


def read(rec):
    k = trace.kernel(rec["trace"], "landmark_block_solve_kernel") \
        if "trace" in rec else None
    if k is None or k[1] <= 0:
        return None
    P, itemsize = rec["shapes"]["P"], rec["shapes"]["itemsize"]
    ops, nbytes = roofline.landmark_block_solve(P, itemsize)
    return 100.0 * roofline.least_seconds(ops, nbytes, itemsize)[0] / k[1]
