"""Factors of the reference's gtsam_unstable: inverse depth, rolling
shutter, the EM between factor, time of arrival and the S2 bearing.

JAX counterpart: gtsam_personal_tpu/slam/unstable.py (all of it; reference:
gtsam_unstable/slam/InvDepthFactorVariant{1,2,3}.h,
ProjectionFactorRollingShutter.h, BetweenFactorEM.h, TOAFactor.h and
gtsam_unstable/geometry/{InvDepthCamera3,Event,BearingS2}.h). Pure residual
functions over one factor's points, batched by vmap, Jacobians by autodiff
through the retraction; scalars keep a trailing axis of size 1 (see
geometry/so3.py on 0-dim tangents). Importing the module registers the
4-vector group `event` (t, x, y, z) of the TOA factors.
"""

import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.geometry import cameras, extra, se2, se3

EVENT = manifolds.vector_space("event", 4)


def _norm1(x):
    return torch.sqrt((x * x).sum(-1, keepdim=True))


# -- inverse depth -------------------------------------------------------------

def _ray(theta, phi):
    """(cos t cos p, sin t cos p, sin p) for theta, phi of shape [..., 1]."""
    return torch.cat([torch.cos(theta) * torch.cos(phi),
                      torch.sin(theta) * torch.cos(phi), torch.sin(phi)],
                     dim=-1)


def _safe_rho(rho):
    return torch.where(rho.abs() < 1e-12, torch.full_like(rho, 1e-12), rho)


def inv_depth_point(x, y, z, theta, phi, rho):
    """World point of the Civera09tro parameterization, anchor + ray / rho
    (reference: InvDepthFactorVariant1.h:91); every argument [..., 1]."""
    return torch.cat([x, y, z], dim=-1) + _ray(theta, phi) / _safe_rho(rho)


def inv_depth_variant1_residual(xs, meas):
    """Pose3 x (x, y, z, theta, phi, rho) -> pixel residual (reference:
    InvDepthFactorVariant1::inverseDepthError). meas: measured [2], cal [5]
    (Cal3_S2)."""
    pose, lm = xs
    pt = inv_depth_point(*lm.split(1, dim=-1))
    return (cameras.project_point(pose, pt, meas["cal"], "cal3_s2")
            - meas["measured"])


def inv_depth_variant2_residual(xs, meas):
    """Pose3 x (theta, phi, rho) with the world anchor in meas (reference:
    InvDepthFactorVariant2.h)."""
    pose, lm = xs
    a = meas["anchor"]
    pt = a + _ray(lm[..., 0:1], lm[..., 1:2]) / _safe_rho(lm[..., 2:3])
    return (cameras.project_point(pose, pt, meas["cal"], "cal3_s2")
            - meas["measured"])


def inv_depth_variant3_residual(xs, meas):
    """Anchor Pose3 x observing Pose3 x (theta, phi, rho) in the anchor
    camera's frame (reference: InvDepthFactorVariant3b.h)."""
    pose_anchor, pose_obs, lm = xs
    ray_cam = _ray(lm[..., 0:1], lm[..., 1:2])
    pt_world = se3.transform_from(pose_anchor,
                                  ray_cam / _safe_rho(lm[..., 2:3]))
    return (cameras.project_point(pose_obs, pt_world, meas["cal"], "cal3_s2")
            - meas["measured"])


# -- rolling shutter -------------------------------------------------------------

def se3_interpolate(a, b, alpha):
    """a * Exp(alpha * Log(a^-1 b)) (reference: interpolate<Pose3>,
    base/Lie.h); alpha of shape [...]."""
    xi = se3.logmap(se3.between(a, b))
    return se3.compose(a, se3.expmap(alpha[..., None] * xi))


def projection_rolling_shutter_residual(xs, meas):
    """Projection through the pose interpolated between two keyframes at
    the row's capture time alpha (reference:
    ProjectionFactorRollingShutter::evaluateError). meas: measured [2],
    alpha [], cal [5]."""
    pose_a, pose_b, point = xs
    pose = se3_interpolate(pose_a, pose_b, meas["alpha"])
    return (cameras.project_point(pose, point, meas["cal"], "cal3_s2")
            - meas["measured"])


# -- EM inlier/outlier between factor -------------------------------------------

_BETWEEN = {"se2": se2.between, "se3": se3.between}


def make_between_em_residual(group: str):
    """BetweenFactorEM: the stacked [sqrt(p_in) W_in r ; sqrt(p_out) W_out
    r], the responsibilities p computed from the current residual and held
    constant under differentiation (`detach`, the JAX package's
    `stop_gradient`). Use with unit noise. meas: measured, w_in [d], w_out
    [d] (sqrt-info diagonals), prior_in [], prior_out []."""
    m = manifolds.get(group)
    between = _BETWEEN.get(group, lambda a, b: b - a)

    def residual(xs, meas):
        x1, x2 = xs
        r = m.local(meas["measured"], between(x1, x2))
        r_c = r.detach()
        w_in, w_out = meas["w_in"], meas["w_out"]

        def log_lik(w, prior):
            return (torch.log(prior)[..., None]
                    + torch.log(w).sum(-1, keepdim=True)
                    - 0.5 * ((w * r_c) ** 2).sum(-1, keepdim=True))

        li = log_lik(w_in, meas["prior_in"])
        lo = log_lik(w_out, meas["prior_out"])
        mx = torch.maximum(li, lo)
        pi, po = torch.exp(li - mx), torch.exp(lo - mx)
        s = pi + po
        return torch.cat([torch.sqrt(pi / s) * (w_in * r),
                          torch.sqrt(po / s) * (w_out * r)], dim=-1)

    residual.__name__ = f"between_em_{group}"
    return residual


# -- time of arrival ----------------------------------------------------------------

SPEED_OF_SOUND = 330.0  # m/s, the reference's default (Event.h)


def toa_residual(xs, meas):
    """Event (t, x, y, z) heard at a known sensor: t + |loc - sensor| / c -
    toa (reference: Event::toa, TOAFactor). meas: sensor [3], toa [], speed
    []."""
    (event,) = xs
    d = _norm1(event[..., 1:4] - meas["sensor"])
    return (event[..., 0:1] + d / meas["speed"][..., None]
            - meas["toa"][..., None])


def toa2_residual(xs, meas):
    """Event x Point3 (an unknown sensor) TOA factor (reference: TOAFactor's
    two-expression constructor)."""
    event, sensor = xs
    d = _norm1(event[..., 1:4] - sensor)
    return (event[..., 0:1] + d / meas["speed"][..., None]
            - meas["toa"][..., None])


# -- S2 bearing --------------------------------------------------------------------

def bearing_s2_residual(xs, meas):
    """Pose3 -> Point3 direction on the sphere: Unit3 local coordinates of
    the predicted body-frame direction at the measured one (reference:
    gtsam_unstable/geometry/BearingS2.h). meas: measured [3], unit."""
    pose, point = xs
    p_body = se3.transform_to(pose, point)
    n = p_body / torch.maximum(_norm1(p_body),
                               torch.full_like(p_body[..., :1], 1e-12))
    return extra.unit3_local(meas["measured"], n)


NAMED = {"inv_depth_variant1": inv_depth_variant1_residual,
         "inv_depth_variant2": inv_depth_variant2_residual,
         "inv_depth_variant3": inv_depth_variant3_residual,
         "projection_rolling_shutter": projection_rolling_shutter_residual,
         "toa": toa_residual,
         "toa2": toa2_residual,
         "bearing_s2": bearing_s2_residual}
FACTORIES = [("between_em_", make_between_em_residual)]
