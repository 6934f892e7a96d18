"""File formats (reference: gtsam_unstable/linear/QPSParser)."""
