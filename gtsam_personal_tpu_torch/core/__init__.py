"""Manifolds, Values and the factor graph (torch)."""
