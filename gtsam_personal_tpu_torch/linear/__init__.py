"""Noise models, linearization and the linear solvers of the port."""
