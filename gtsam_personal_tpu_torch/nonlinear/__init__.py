"""Nonlinear optimizers: Gauss-Newton and Levenberg-Marquardt (torch)."""
