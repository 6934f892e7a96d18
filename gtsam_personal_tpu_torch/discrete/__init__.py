"""Discrete inference (reference: gtsam/discrete/)."""
