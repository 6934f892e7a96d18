"""SLAM factors, dataset I/O, initialization, the Manhattan-world generator
and trajectory metrics."""
