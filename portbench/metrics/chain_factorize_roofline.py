"""Percent of its roofline that the chain_factorize kernel reaches: the
least time of one call at the engine's capacity, block size and dtype
(roofline.py) over its mean device time in the traced stretch. The kernel
is a dependent chain, so the share is small."""

from portbench import roofline, trace


def read(rec):
    k = trace.kernel(rec["trace"], "chain_factorize_kernel") \
        if "trace" in rec else None
    if k is None or k[1] <= 0:
        return None
    s = rec["shapes"]
    ops, nbytes = roofline.chain_factorize(s["cap"], s["d"], s["itemsize"])
    return 100.0 * roofline.least_seconds(ops, nbytes, s["itemsize"])[0] \
        / k[1]
