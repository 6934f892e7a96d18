"""Percent of the traced stretch of an ISAM2 cell in which the device ran
nothing: 100 (1 - busy / wall)."""

from portbench import trace


def read(rec):
    return trace.idle_share(rec)
