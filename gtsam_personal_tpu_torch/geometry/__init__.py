"""Batched SO(3)/SE(3) geometry and Cal3Bundler projection (torch)."""
