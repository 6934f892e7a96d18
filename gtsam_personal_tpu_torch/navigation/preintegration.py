"""IMU preintegration on the 9-D tangent space, the manifold backend and
AHRS, with the scans in hand-written kernels.

JAX counterpart: gtsam_personal_tpu/navigation/preintegration.py (all of
it; reference: gtsam/navigation/TangentPreintegration.{h,cpp},
ManifoldPreintegration, PreintegrationBase::biasCorrectedDelta / predict /
computeError, PreintegratedAhrsMeasurements). The state zeta = (theta, dpos,
dvel) integrates in the tangent frame at t_i:

  theta+ = theta + Jr(theta)^{-1} w dt
  pos+   = pos + vel dt + Exp(theta) a dt^2/2
  vel+   = vel + Exp(theta) a dt

with the bias Jacobians and the covariance propagated by the derivatives
A, B, C of that update (ops/preintegration.py).

The public functions keep the JAX package's single-segment form (accs,
gyros [N, 3], dts [N]); `integrate_batch`, `integrate_manifold_batch` and
`integrate_ahrs_batch` take [S, N] samples, S segments in one kernel launch,
a shorter segment padded with samples of dt = 0 (`pad_segments`). A PIM of
S segments carries a leading S on every field.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.geometry import so3
from gtsam_personal_tpu_torch.navigation import navstate
from gtsam_personal_tpu_torch.ops import preintegration as ops


class PreintegrationParams(NamedTuple):
    """Reference: PreintegrationParams (navigation/PreintegrationParams.h)."""
    gravity: torch.Tensor               # [3] in the nav frame
    accel_cov: torch.Tensor             # [3, 3] continuous-time accel noise
    gyro_cov: torch.Tensor              # [3, 3]
    integration_cov: torch.Tensor       # [3, 3] position integration noise
    bias_acc_cov: Optional[torch.Tensor] = None   # [3, 3] random walk
    bias_omega_cov: Optional[torch.Tensor] = None

    @staticmethod
    def make_shared_u(g=9.81, accel_sigma=0.1, gyro_sigma=0.01,
                      integration_sigma=1e-4, *, device="cuda",
                      dtype=torch.float64):
        """MakeSharedU analogue: Z-up navigation frame, gravity (0, 0, -g);
        on the card unless `device` names another."""
        device = config.device(device)
        eye = torch.eye(3, device=device, dtype=dtype)
        return PreintegrationParams(
            gravity=torch.tensor([0.0, 0.0, -g], device=device, dtype=dtype),
            accel_cov=accel_sigma ** 2 * eye, gyro_cov=gyro_sigma ** 2 * eye,
            integration_cov=integration_sigma ** 2 * eye,
            bias_acc_cov=1e-5 * eye, bias_omega_cov=1e-6 * eye)

    def covs(self, like):
        """(accel, gyro, integration) covariances [3, 3, 3] in the dtype
        and on the device of `like`, the kernels' form."""
        return torch.stack([self.accel_cov, self.gyro_cov,
                            self.integration_cov]).to(like).contiguous()


class PIM(NamedTuple):
    """Preintegrated IMU measurements (reference:
    PreintegratedImuMeasurements)."""
    zeta: torch.Tensor       # [..., 9] (theta, dp, dv)
    H_ba: torch.Tensor       # [..., 9, 3] d zeta / d accel bias
    H_bw: torch.Tensor       # [..., 9, 3] d zeta / d gyro bias
    cov: torch.Tensor        # [..., 9, 9] preintMeasCov
    bias_hat: torch.Tensor   # [..., 6] (ba, bw) used during integration
    deltaT: torch.Tensor     # [...] total dt


class AhrsPIM(NamedTuple):
    """Preintegrated gyro measurements (reference:
    PreintegratedAhrsMeasurements, AHRSFactor.h:36)."""
    theta: torch.Tensor      # [..., 3] Log(deltaRij)
    H_bw: torch.Tensor       # [..., 3, 3] d theta / d gyro bias
    cov: torch.Tensor        # [..., 3, 3] preintMeasCov
    bias_hat: torch.Tensor   # [..., 3]
    deltaT: torch.Tensor


def _matvec(A, x):
    return (A @ x[..., None])[..., 0]


def pad_segments(segments: Sequence, dt, *, device, dtype):
    """Ragged segments -> (accs, gyros [S, N, 3], dts [S, N]): segment k is
    an array [n_k, 6] of (acc, gyro) rows sampled every `dt` seconds,
    padded to the longest with samples of dt = 0, which leave a PIM as it
    is."""
    S = len(segments)
    N = max((len(s) for s in segments), default=0)
    buf = np.zeros((S, N, 6))
    dts = np.zeros((S, N))
    for k, s in enumerate(segments):
        s = np.asarray(s, dtype=np.float64).reshape(-1, 6)
        buf[k, :len(s)] = s
        dts[k, :len(s)] = dt

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), device=device,
                            dtype=dtype)
    return t(buf[..., :3]), t(buf[..., 3:]), t(dts)


def _segments(bias_hat, accs, gyros, dts):
    """The [S, ...] batch of a single-segment call."""
    return bias_hat[None], accs[None], gyros[None], dts[None]


def integrate_batch(params: PreintegrationParams, bias_hat, accs, gyros,
                    dts) -> PIM:
    """Integrate S segments in one kernel launch: bias_hat [S, 6], accs,
    gyros [S, N, 3], dts [S, N] -> PIM with a leading S."""
    bias_hat = bias_hat.contiguous()
    zeta, H, cov, total = ops.preint_tangent(
        accs.contiguous(), gyros.contiguous(), dts.contiguous(), bias_hat,
        params.covs(accs))
    return PIM(zeta, H[..., :3], H[..., 3:], cov, bias_hat, total)


def integrate(params: PreintegrationParams, bias_hat, accs, gyros,
              dts) -> PIM:
    """Integrate one segment: accs, gyros [N, 3], dts [N] -> PIM
    (reference: integrateMeasurement called N times)."""
    pim = integrate_batch(params, *_segments(bias_hat, accs, gyros, dts))
    return PIM(*(x[0] for x in pim))


def bias_corrected_delta(pim: PIM, bias):
    """First-order bias correction
    (TangentPreintegration::biasCorrectedDelta)."""
    incr = bias - pim.bias_hat
    return (pim.zeta + _matvec(pim.H_ba, incr[..., :3])
            + _matvec(pim.H_bw, incr[..., 3:]))


def correct_pim(state_i, zeta, dt, gravity):
    """NavState::correctPIM (NavState.cpp:462): the initial velocity and
    gravity in the body frame of state_i. dt [...] or [..., 1]."""
    Rt = navstate.rotation(state_i).transpose(-1, -2)
    v = navstate.velocity(state_i)
    dt = dt.reshape(zeta.shape[:-1] + (1,))
    dt22 = 0.5 * dt * dt
    Rtg = _matvec(Rt, gravity)
    return torch.cat([zeta[..., :3],
                      zeta[..., 3:6] + dt * _matvec(Rt, v) + dt22 * Rtg,
                      zeta[..., 6:9] + dt * Rtg], dim=-1)


def predict(pim: PIM, params: PreintegrationParams, state_i, bias):
    """PreintegrationBase::predict (PreintegrationBase.cpp:117)."""
    zeta = bias_corrected_delta(pim, bias)
    xi = correct_pim(state_i, zeta, pim.deltaT, params.gravity.to(zeta))
    return navstate.retract(state_i, xi)


def compute_error(pim: PIM, params: PreintegrationParams, state_i, state_j,
                  bias):
    """PreintegrationBase::computeError: Local(state_j, predict(state_i))."""
    return navstate.local(state_j, predict(pim, params, state_i, bias))


# -- the manifold backend (reference: ManifoldPreintegration.{h,cpp}) ---------

def _log_with_tangents(R, dR):
    """Log(R) [S, 3] and its derivative along each tangent dR [S, nd, 3, 3]
    -> [S, 3, nd]: the chain rule through so3.logmap that jacfwd of the
    whole scan takes."""
    def one(R1, dR1):
        return torch.func.jvp(so3.logmap, (R1,), (dR1,))[1]
    per_dir = torch.func.vmap(torch.func.vmap(one, in_dims=(None, 0)))
    return so3.logmap(R), per_dir(R, dR).transpose(1, 2)


def integrate_manifold_batch(params: PreintegrationParams, bias_hat, accs,
                             gyros, dts) -> PIM:
    """ManifoldPreintegration analogue of S segments: deltaR composes
    exactly, the bias Jacobians are the forward-mode tangents of the whole
    scan (the `preint_rotation` kernel), the covariance is the tangent
    backend's (`preint_tangent`), as in the JAX package."""
    bias_hat = bias_hat.contiguous()
    accs, gyros, dts = accs.contiguous(), gyros.contiguous(), dts.contiguous()
    R, p, v, dR, dp, dv = ops.preint_rotation("manifold", gyros, dts,
                                              bias_hat, accs=accs)
    theta, H_theta = _log_with_tangents(R, dR)
    zeta = torch.cat([theta, p, v], dim=-1)
    H = torch.cat([H_theta, dp.transpose(1, 2), dv.transpose(1, 2)], dim=1)
    _, _, cov, total = ops.preint_tangent(accs, gyros, dts, bias_hat,
                                          params.covs(accs))
    return PIM(zeta, H[..., :3], H[..., 3:], cov, bias_hat, total)


def integrate_manifold(params: PreintegrationParams, bias_hat, accs, gyros,
                       dts) -> PIM:
    """One segment through `integrate_manifold_batch`."""
    pim = integrate_manifold_batch(params,
                                   *_segments(bias_hat, accs, gyros, dts))
    return PIM(*(x[0] for x in pim))


# -- AHRS (reference: AHRSFactor.h, PreintegratedRotation.h) -------------------

def integrate_ahrs_batch(gyro_cov, bias_hat, gyros, dts) -> AhrsPIM:
    """PreintegratedAhrsMeasurements of S segments in one launch: bias_hat
    [S, 3], gyros [S, N, 3], dts [S, N]."""
    bias_hat = bias_hat.contiguous()
    R, dR, cov = ops.preint_rotation(
        "ahrs", gyros.contiguous(), dts.contiguous(), bias_hat,
        gyro_cov=gyro_cov.to(gyros).contiguous())
    theta, H = _log_with_tangents(R, dR)
    return AhrsPIM(theta, H, cov, bias_hat, dts.sum(-1))


def integrate_ahrs(gyro_cov, bias_hat, gyros, dts) -> AhrsPIM:
    """One segment: gyros [N, 3], dts [N]."""
    pim = integrate_ahrs_batch(gyro_cov, bias_hat[None], gyros[None],
                               dts[None])
    return AhrsPIM(*(x[0] for x in pim))


def ahrs_residual(xs, meas):
    """AHRSFactor::evaluateError (AHRSFactor.cpp): Log((deltaRij Exp(H (b -
    b_hat)))^{-1} Ri^{-1} Rj). Variables: (Ri, Rj, gyro bias [3])."""
    Ri, Rj, bias = xs
    theta_corr = meas["theta"] + _matvec(meas["H_bw"],
                                         bias - meas["bias_hat"])
    dR = so3.expmap(theta_corr)
    return so3.logmap(dR.transpose(-1, -2)
                      @ (Ri.transpose(-1, -2) @ Rj))


# -- numpy in and out ----------------------------------------------------------

_PARAM_FIELDS = PreintegrationParams._fields


def params_from_numpy(p, *, device="cuda", dtype=torch.float64):
    """PreintegrationParams from any record with its fields (the JAX
    package's NamedTuple, a dict) whose values are arrays or None; on the
    card unless `device` names another."""
    device = config.device(device)
    get = p.get if isinstance(p, dict) else lambda k: getattr(p, k, None)
    return PreintegrationParams(*(
        None if get(k) is None else torch.tensor(np.asarray(get(k)),
                                                 device=device, dtype=dtype)
        for k in _PARAM_FIELDS))


def pim_from_numpy(p, *, device="cuda", dtype=torch.float64) -> PIM:
    """A PIM from any record with its fields (the JAX package's PIM, a
    dict, `pim_to_numpy`'s output); on the card unless `device` names
    another."""
    device = config.device(device)
    get = p.get if isinstance(p, dict) else lambda k: getattr(p, k)
    return PIM(*(torch.tensor(np.asarray(get(k)), device=device, dtype=dtype)
                 for k in PIM._fields))


def pim_to_numpy(pim: PIM) -> dict:
    """{field: numpy array} of a PIM."""
    return {k: getattr(pim, k).detach().cpu().numpy() for k in PIM._fields}
