"""Test oracles (JAX counterpart: gtsam_personal_tpu/testing/)."""
