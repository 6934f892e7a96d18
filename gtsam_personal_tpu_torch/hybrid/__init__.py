"""Hybrid discrete-continuous inference (reference: gtsam/hybrid/)."""
