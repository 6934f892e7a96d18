"""Operations, bytes and the least time of each hand-written kernel of the
program, from its shapes alone (the yardstick of the `*_roofline`
metrics).

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again. The least time is the larger of the
operations over the card's peak rate and the bytes over its memory rate
(peaks.json).
"""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def flop_rate(itemsize):
    return PEAKS["fp64_flop_per_s" if itemsize == 8 else "fp32_flop_per_s"]


def landmark_block_solve(P, itemsize):
    """(operations, bytes) of u = (H + lam I)^-1 t for P symmetric 3x3
    blocks: 6 entries of H and 3 of t read, 3 of u written a block (lam is
    one element); the closed-form inverse and product take 48 operations a
    block: 3 diagonal adds, 6 cofactors of 3, the determinant 5, its
    reciprocal 1, 6 scalings and 15 of the product."""
    return 48 * P, (6 + 3 + 3) * P * itemsize


def least_seconds(ops, nbytes, itemsize):
    """(seconds, 'operations' or 'bytes')."""
    by_ops = ops / flop_rate(itemsize)
    by_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes,
                                                             "bytes")


def chain_factorize(cap, d, itemsize):
    """(operations, bytes) of the block-tridiagonal chain factorization over
    `cap` blocks of d x d: D and O read and Uinv written, d^2 entries each a
    block; a block takes T = Uinv O and A = D - O^T T (d^3 multiply-adds
    each) and the inverse of A (d^3 more), at 2 operations a multiply-add."""
    return 6 * d ** 3 * cap, 3 * cap * d * d * itemsize
