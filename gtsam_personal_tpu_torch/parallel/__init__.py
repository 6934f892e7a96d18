"""Distributed solvers over torch.distributed process groups (JAX
counterpart: gtsam_personal_tpu/parallel/, over jax.sharding.Mesh)."""
