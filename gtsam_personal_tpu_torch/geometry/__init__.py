"""Batched SO(2)/SE(2)/SO(3)/SE(3) geometry and Cal3Bundler projection."""
