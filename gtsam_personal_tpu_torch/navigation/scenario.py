"""IMU simulation scenarios: ground-truth trajectories and ideal IMU samples.

JAX counterpart: gtsam_personal_tpu/navigation/scenario.py (all of it;
reference: gtsam/navigation/Scenario.h, ScenarioRunner.h). The scenarios
evaluate at one time or at an array of times, in float64 on the CPU; the
IMU samples are numpy arrays, made for all samples at once (the JAX package
loops over them).
"""

from typing import NamedTuple

import numpy as np
import torch

from gtsam_personal_tpu_torch.geometry import se3, so3
from gtsam_personal_tpu_torch.navigation import navstate


def _f64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _times(t):
    return _f64(t)[..., None]


def _matvec(A, x):
    return (A @ x[..., None])[..., 0]


class ConstantTwistScenario(NamedTuple):
    """The body moves with a constant twist (omega_b, v_b): T(t) =
    Exp(t [omega, v])."""
    omega_b: np.ndarray
    v_b: np.ndarray

    def pose(self, t):
        """[..., 3, 4] at the time(s) t."""
        tt = _times(t)
        return se3.expmap(torch.cat([_f64(self.omega_b) * tt,
                                     _f64(self.v_b) * tt], dim=-1))

    def nav_state(self, t):
        pose = self.pose(t)
        return navstate.from_pose_vel(
            pose, _matvec(se3.rotation(pose), _f64(self.v_b)))

    def imu_measurements(self, t_end, dt, gravity):
        """Ideal (acc, gyro) samples over [0, t_end), constant in the body
        frame: specific force omega x v - R^T g."""
        n = int(round(t_end / dt))
        R = se3.rotation(self.pose(np.arange(n) * dt)).numpy()
        w = np.asarray(self.omega_b, dtype=np.float64)
        a_c = np.cross(w, np.asarray(self.v_b, dtype=np.float64))
        accs = a_c - np.einsum("nji,j->ni", R, np.asarray(gravity))
        return accs, np.tile(w, (n, 1)), np.full(n, dt)


class AcceleratingScenario(NamedTuple):
    """Constant nav-frame acceleration a_n from an initial state, constant
    body rate omega_b (reference: Scenario.h:79 AcceleratingScenario)."""
    R0: np.ndarray        # [3, 3] initial attitude
    p0: np.ndarray        # [3]
    v0: np.ndarray        # [3] nav-frame initial velocity
    a_n: np.ndarray       # [3] nav-frame acceleration
    omega_b: np.ndarray   # [3] body rotation rate

    def pose(self, t):
        tt = _times(t)
        R = _f64(self.R0) @ so3.expmap(_f64(self.omega_b) * tt)
        p = _f64(self.p0) + _f64(self.v0) * tt + 0.5 * tt * tt * _f64(self.a_n)
        return se3.make(R, p)

    def nav_state(self, t):
        v = _f64(self.v0) + _f64(self.a_n) * _times(t)
        return navstate.from_pose_vel(self.pose(t), v)

    def imu_measurements(self, t_end, dt, gravity):
        """Ideal body-frame IMU: gyro = omega_b; specific force
        R(t)^T (a_n - g)."""
        n = int(round(t_end / dt))
        R = se3.rotation(self.pose(np.arange(n) * dt)).numpy()
        f = np.asarray(self.a_n) - np.asarray(gravity)
        accs = np.einsum("nji,j->ni", R, f)
        return (accs, np.tile(np.asarray(self.omega_b, dtype=np.float64),
                              (n, 1)), np.full(n, dt))
