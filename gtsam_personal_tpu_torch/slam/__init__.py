"""SLAM factors, the Manhattan-world generator and trajectory metrics."""
