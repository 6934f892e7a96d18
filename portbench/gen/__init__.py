"""Seeded stand-ins for the benchmark's public datasets, in numpy.

Frozen copies: a change to the program never changes what the benchmark
feeds it. Each generator splits its draws in two: the structure of the
dataset (which camera sees which point, the trajectory and its loop
closures) comes from the configuration's own `structure_seed`, so every run
solves a problem of the same shape; the measurement noise and the start come
from the run's `--seed`.
"""
