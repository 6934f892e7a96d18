"""Checkpointing: Values, factor graphs, the LM carry and ISAM2 to files."""
