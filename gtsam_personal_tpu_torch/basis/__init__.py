"""Pseudospectral bases (reference: gtsam/basis/)."""
