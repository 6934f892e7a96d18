"""Inertial navigation (JAX counterpart: gtsam_personal_tpu/navigation/):
NavState, IMU preintegration with its scans in hand-written kernels, the
IMU, GPS, attitude, magnetometer and dynamics factors, simulation scenarios
and geodetic conversions."""
