"""Percent of the traced stretch of a BA cell in which the device ran
nothing: 100 (1 - busy / wall)."""

from portbench import trace


def read(rec):
    return trace.idle_share(rec)
