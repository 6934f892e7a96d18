"""Dynamics factors of gtsam_unstable/dynamics.

JAX counterpart: gtsam_personal_tpu/navigation/dynamics.py (all of it).
The reference's PoseRTV (pose and translation rate, gtsam_unstable/dynamics/
PoseRTV.h) is the (se3, vel3) pair of variables per timestep. The factors
are pure residual functions:

- VelocityConstraint  (VelocityConstraint.h): position integration between
  consecutive states, trapezoidal or Euler;
- VelocityConstraint3 (VelocityConstraint3.h): scalar x2 = x1 + v dt;
- the pendulum factors (Pendulum.h): PendulumFactor1 (position update),
  PendulumFactor2 (velocity update), PendulumFactorPk / PendulumFactorPk1
  (discrete Euler-Lagrange momenta).

Hard constraints (the reference's noiseModel::Constrained, mu = 1000) are
large-weight diagonal noise, as in the JAX package.
"""

import torch

from gtsam_personal_tpu_torch.geometry import se3

TRAPEZOIDAL = "trapezoidal"
EULER_START = "euler_start"
EULER_END = "euler_end"


def make_velocity_constraint_residual(mode: str = TRAPEZOIDAL):
    """(se3, vel3, se3, vel3) -> r3: t2 - integrate(t1, v1, v2, dt)
    (VelocityConstraint::evaluateError_, VelocityConstraint.h:112-121).
    meas: dt []."""

    def residual(xs, meas):
        x1, v1, x2, v2 = xs
        p1 = se3.translation(x1)
        dt = meas["dt"]
        if mode == TRAPEZOIDAL:
            hx = p1 + 0.5 * (v1 + v2) * dt
        elif mode == EULER_START:
            hx = p1 + v1 * dt
        else:
            hx = p1 + v2 * dt
        return se3.translation(x2) - hx

    residual.__name__ = f"velocity_constraint_{mode}"
    return residual


def velocity_constraint3_residual(xs, meas):
    """(r1 x1, r1 x2, r1 v): x1 + v dt - x2 (VelocityConstraint3.h)."""
    x1, x2, v = xs
    return x1 + v * meas["dt"] - x2


def pendulum1_residual(xs, meas):
    """q_{k+1} = q_k + v_{k+1} h (PendulumFactor1, Pendulum.h:51-58).
    Slots (qk1, qk, v), all r1; meas: h."""
    qk1, qk, v = xs
    return qk + v * meas["h"] - qk1


def pendulum2_residual(xs, meas):
    """v_{k+1} = v_k - (g/r) sin(q) h (PendulumFactor2, Pendulum.h:101-108).
    Slots (vk1, vk, q); meas: h, g, r."""
    vk1, vk, q = xs
    return vk - meas["h"] * meas["g"] / meas["r"] * torch.sin(q) - vk1


def pendulum_pk_residual(xs, meas):
    """Discrete Euler-Lagrange momentum at k (PendulumFactorPk). Slots
    (pk, qk, qk1); meas: h, m, r, g, alpha."""
    pk, qk, qk1 = xs
    h, mm, r, g, alpha = (meas[k] for k in ("h", "m", "r", "g", "alpha"))
    qmid = (1 - alpha) * qk + alpha * qk1
    hx = (mm * r * r / h * (qk1 - qk)
          + mm * g * r * h * (1 - alpha) * torch.sin(qmid))
    return hx - pk


def pendulum_pk1_residual(xs, meas):
    """Momentum at k+1 (PendulumFactorPk1). Slots (pk1, qk, qk1); meas: h,
    m, r, g, alpha."""
    pk1, qk, qk1 = xs
    h, mm, r, g, alpha = (meas[k] for k in ("h", "m", "r", "g", "alpha"))
    qmid = (1 - alpha) * qk + alpha * qk1
    hx = (mm * r * r / h * (qk1 - qk)
          - mm * g * r * h * alpha * torch.sin(qmid))
    return hx - pk1
