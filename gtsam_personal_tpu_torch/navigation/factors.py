"""Inertial-navigation factors: ImuFactor, CombinedImuFactor, GPS, attitude,
constant velocity, barometric, magnetometer, biased GPS, Gauss-Markov.

JAX counterpart: gtsam_personal_tpu/navigation/factors.py (all of it;
reference: gtsam/navigation/ImuFactor.h:170, CombinedImuFactor, GPSFactor.h:63,
AttitudeFactor, ConstantVelocityFactor, BarometricFactor, MagFactor.h,
MagPoseFactor.h, AHRSFactor.h, gtsam_unstable/slam/BiasedGPSFactor.h and
GaussMarkov1stOrderFactor.h). The residuals are pure functions of ONE
factor's variables; NavStates are rebuilt from (se3, vel3) slots, and the
measurement dicts carry the PIM's arrays. The builder sugar adds a factor
to a core/graph.py:GraphBuilder, whose measurements are numpy arrays.
"""

import numpy as np
import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.geometry import se3
from gtsam_personal_tpu_torch.navigation import (dynamics, navstate,
                                                  preintegration as pre)


def _matvec(A, x):
    return (A @ x[..., None])[..., 0]


def imu_residual(xs, meas):
    """9-D residual of ImuFactor (reference: ImuFactor::evaluateError,
    ImuFactor.cpp:153 -> PreintegrationBase::computeErrorAndJacobians).
    Variables: (pose_i, vel_i, pose_j, vel_j, bias); meas: zeta, H_ba, H_bw,
    bias_hat, deltaT, gravity."""
    pose_i, vel_i, pose_j, vel_j, bias = xs
    pim = pre.PIM(meas["zeta"], meas["H_ba"], meas["H_bw"], None,
                  meas["bias_hat"], meas["deltaT"])
    state_i = navstate.from_pose_vel(pose_i, vel_i)
    state_j = navstate.from_pose_vel(pose_j, vel_j)
    zeta = pre.bias_corrected_delta(pim, bias)
    xi = pre.correct_pim(state_i, zeta, pim.deltaT, meas["gravity"])
    return navstate.local(state_j, navstate.retract(state_i, xi))


def combined_imu_residual(xs, meas):
    """15-D residual: the IMU error and the bias random walk (reference:
    CombinedImuFactor, 6-way; the bias-walk block is independent, as in
    the JAX package)."""
    pose_i, vel_i, pose_j, vel_j, bias_i, bias_j = xs
    r_imu = imu_residual((pose_i, vel_i, pose_j, vel_j, bias_i), meas)
    return torch.cat([r_imu, bias_j - bias_i], dim=-1)


def gps_residual(xs, meas):
    """GPSFactor::evaluateError = translation(pose) - measured
    (navigation/GPSFactor.h:63)."""
    (pose,) = xs
    return se3.translation(pose) - meas["measured"]


def attitude_residual(xs, meas):
    """The rotated body reference direction against the measured nav-frame
    direction, as their cross product (reference: AttitudeFactor; rank 2,
    as in the JAX package)."""
    (pose,) = xs
    pred = _matvec(se3.rotation(pose), meas["bRef"])
    return torch.linalg.cross(pred, meas["nZ"], dim=-1)


def constant_velocity_residual(xs, meas):
    """Velocities equal between consecutive states (reference:
    ConstantVelocityFactor)."""
    v1, v2 = xs
    return v2 - v1


def barometric_residual(xs, meas):
    """Height with a bias slot (reference: BarometricFactor, simplified to a
    direct altitude observation as in the JAX package)."""
    pose, b = xs
    return torch.atleast_1d(se3.translation(pose)[..., 2] + b[..., 0]
                            - meas["height"])


# -- magnetometer factors (reference: gtsam/navigation/MagFactor.h) -----------

def mag_rot3_residual(xs, meas):
    """MagFactor1: nRb^T nM + bias - measured (MagFactor.h:121)."""
    (nRb,) = xs
    return (_matvec(nRb.transpose(-1, -2), meas["nM"]) + meas["bias"]
            - meas["measured"])


def mag_field_bias_residual(xs, meas):
    """MagFactor2: unknown field nM and bias, known bRn (MagFactor.h:162)."""
    nM, bias = xs
    return _matvec(meas["bRn"], nM) + bias - meas["measured"]


def mag_scale_dir_bias_residual(xs, meas):
    """MagFactor3: scale * bRn direction + bias - measured
    (MagFactor.h:174)."""
    scale, direction, bias = xs
    return (scale[..., 0:1] * _matvec(meas["bRn"], direction) + bias
            - meas["measured"])


def mag_pose_residual(xs, meas):
    """MagPoseFactor<Pose3>: the field in the body frame of a full pose
    (navigation/MagPoseFactor.h)."""
    (pose,) = xs
    return (_matvec(se3.rotation(pose).transpose(-1, -2), meas["nM"])
            + meas["bias"] - meas["measured"])


def biased_gps_residual(xs, meas):
    """BiasedGPSFactor: translation(pose) + bias - measured, the bias in the
    world frame (gtsam_unstable/slam/BiasedGPSFactor.h:78)."""
    pose, bias = xs
    return se3.translation(pose) + bias - meas["measured"]


def gauss_markov_residual(xs, meas):
    """GaussMarkov1stOrderFactor: v2 - exp(-dt / tau) v1 elementwise
    (gtsam_unstable/slam/GaussMarkov1stOrderFactor.h:31). meas: dt [1] or
    scalar, tau [d]."""
    v1, v2 = xs
    return v2 - torch.exp(-meas["dt"] / meas["tau"]) * v1


def gauss_markov_discrete_sigmas(sigmas_ct, dt):
    """Continuous-time process sigmas -> discrete factor sigmas, Q_d ~ Q dt
    (GaussMarkov1stOrderFactor.h:127 calcDiscreteNoiseModel)."""
    return np.asarray(sigmas_ct) * np.sqrt(dt)


# -- builder sugar ---------------------------------------------------------------

def _pim_meas(pim: pre.PIM, params: pre.PreintegrationParams):
    p = pre.pim_to_numpy(pim)
    p.pop("cov")
    p["gravity"] = params.gravity.detach().cpu().numpy()
    return p


def _info(cov):
    cov = np.asarray(cov, dtype=np.float64)
    return np.linalg.inv(0.5 * (cov + cov.T))


def add_imu_factor(builder, i, j, bias_key, pim: pre.PIM,
                   params: pre.PreintegrationParams, pose_group="se3",
                   vel_group="vel3", bias_group="imu_bias"):
    """Add an ImuFactor to a GraphBuilder; noise: the square-root
    information of the PIM's covariance."""
    from gtsam_personal_tpu_torch.slam.factors import full_info_noise
    builder.add("imu", imu_residual,
                (pose_group, vel_group, pose_group, vel_group, bias_group), 9,
                [i, i, j, j, bias_key], _pim_meas(pim, params),
                full_info_noise(_info(pim.cov.detach().cpu().numpy())))


def add_combined_imu_factor(builder, i, j, bias_i, bias_j, pim: pre.PIM,
                            params: pre.PreintegrationParams, dt_bias=None,
                            pose_group="se3", vel_group="vel3",
                            bias_group="imu_bias"):
    """Add a CombinedImuFactor; the bias block's covariance is the random
    walk over the PIM's deltaT (or `dt_bias`)."""
    from gtsam_personal_tpu_torch.slam.factors import full_info_noise
    T = float(pim.deltaT) if dt_bias is None else dt_bias
    bcov = np.zeros((6, 6))
    bcov[:3, :3] = params.bias_acc_cov.cpu().numpy() * max(T, 1e-9)
    bcov[3:, 3:] = params.bias_omega_cov.cpu().numpy() * max(T, 1e-9)
    info15 = np.zeros((15, 15))
    info15[:9, :9] = _info(pim.cov.detach().cpu().numpy())
    info15[9:, 9:] = np.linalg.inv(bcov)
    builder.add("combined_imu", combined_imu_residual,
                (pose_group, vel_group, pose_group, vel_group, bias_group,
                 bias_group), 15, [i, i, j, j, bias_i, bias_j],
                _pim_meas(pim, params), full_info_noise(info15))


def add_gps_factor(builder, i, position, noise_dict, pose_group="se3"):
    builder.add("gps", gps_residual, (pose_group,), 3, [i],
                {"measured": np.asarray(position)}, noise_dict)


def add_ahrs_factor(builder, i, j, bias_key, apim: pre.AhrsPIM,
                    rot_group="so3", bias_group="gyro_bias"):
    """Add an AHRSFactor (Rot_i, Rot_j, gyro bias) to a GraphBuilder
    (AHRSFactor.h:135)."""
    from gtsam_personal_tpu_torch.slam.factors import full_info_noise
    manifolds.vector_space(bias_group, 3)
    meas = {k: getattr(apim, k).detach().cpu().numpy()
            for k in ("theta", "H_bw", "bias_hat")}
    builder.add("ahrs", pre.ahrs_residual, (rot_group, rot_group, bias_group),
                3, [i, j, bias_key], meas,
                full_info_noise(_info(apim.cov.detach().cpu().numpy())))


# -- names ---------------------------------------------------------------------

# the residuals of this module, of navigation/dynamics.py and AHRS by batch
# name, for slam/factors.py:residual_by_name
NAMED = {"imu": imu_residual,
         "combined_imu": combined_imu_residual,
         "gps": gps_residual,
         "attitude": attitude_residual,
         "constant_velocity": constant_velocity_residual,
         "barometric": barometric_residual,
         "mag_rot3": mag_rot3_residual,
         "mag_field_bias": mag_field_bias_residual,
         "mag_scale_dir_bias": mag_scale_dir_bias_residual,
         "mag_pose": mag_pose_residual,
         "biased_gps": biased_gps_residual,
         "gauss_markov": gauss_markov_residual,
         "ahrs": pre.ahrs_residual,
         "velocity_constraint3": dynamics.velocity_constraint3_residual,
         "pendulum1": dynamics.pendulum1_residual,
         "pendulum2": dynamics.pendulum2_residual,
         "pendulum_pk": dynamics.pendulum_pk_residual,
         "pendulum_pk1": dynamics.pendulum_pk1_residual,
         **{f"velocity_constraint_{mode}":
            dynamics.make_velocity_constraint_residual(mode)
            for mode in (dynamics.TRAPEZOIDAL, dynamics.EULER_START,
                         dynamics.EULER_END)}}
