"""Hand-written CUDA kernels with their plain torch versions."""
