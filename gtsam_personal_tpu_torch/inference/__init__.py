"""Host-side graph partitioning (numpy/scipy)."""
