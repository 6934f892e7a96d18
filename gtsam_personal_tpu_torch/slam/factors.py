"""SLAM measurement factors: priors, between factors, bearing/range,
landmark, projection, plane, transfer and the long-tail factors.

JAX counterpart: gtsam_personal_tpu/slam/factors.py (all of it: the
residuals, add_prior, add_between, diag_noise, full_info_noise; reference:
gtsam/slam/*.h, nonlinear/PriorFactor.h, sam/BearingRangeFactor.h,
sfm/TransferFactor.h and gtsam_unstable/slam/*.h). Each factor type is a
pure residual function over ONE factor's manifold points; the Jacobians come
from forward-mode differentiation through the retraction
(linear/linearize.py). The residuals are written over leading batch axes
too, as the geometry is, and keep scalars as [..., 1] (see geometry/so3.py
on 0-dim tangents).

Residual conventions match the reference, so costs are comparable:
- prior:    r = Local(prior, x)                      (PriorFactor)
- between:  r = Local(measured, between(x1, x2))     (BetweenFactor)

`residual_by_name` gives the residual function of a batch from a name alone,
for graphs that cross from numpy, from the JAX package or from a file
(utils/serialization.py); `residual_names` lists the names phase 13 of
chip_smoke.py and tests/test_torch_factors_breadth.py drive.
"""

import numpy as np
import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.geometry import (cameras, extra, fundamental,
                                               se2, se3, so2, so3)
from gtsam_personal_tpu_torch.navigation import factors as nav
from gtsam_personal_tpu_torch.slam import unstable

_BETWEEN = {"se2": se2.between, "se3": se3.between, "so3": so3.between,
            "so2": so2.between}


def make_prior_residual(group: str):
    m = manifolds.get(group)

    def residual(xs, meas):
        (x,) = xs
        return m.local(meas["prior"], x)

    residual.__name__ = f"prior_{group}"
    return residual


def make_between_residual(group: str):
    m = manifolds.get(group)
    between = _BETWEEN.get(group, lambda a, b: b - a)   # else a vector space

    def residual(xs, meas):
        x1, x2 = xs
        return m.local(meas["measured"], between(x1, x2))

    residual.__name__ = f"between_{group}"
    return residual


def bearing_range_2d_residual(xs, meas):
    """Pose2 -> Point2 bearing and range (reference: BearingRangeFactor with
    A1 = Pose2, A2 = Point2): [wrapped bearing error, range error]."""
    pose, point = xs
    db = so2.wrap(se2.bearing(pose, point) - meas["bearing"])
    return torch.stack([db, se2.range_to(pose, point) - meas["range"]])


def range_2d_residual(xs, meas):
    pose, point = xs
    return (se2.range_to(pose, point) - meas["range"]).reshape(1)


def pose_point_2d_residual(xs, meas):
    """Observation of a landmark in the pose frame (simulated2D style)."""
    pose, point = xs
    return se2.transform_to(pose, point) - meas["measured"]


def pose_point_3d_residual(xs, meas):
    pose, point = xs
    return se3.transform_to(pose, point) - meas["measured"]


def _norm1(x):
    """Euclidean norm over the last axis as [..., 1], as sqrt(sum(x^2))."""
    return torch.sqrt((x * x).sum(-1, keepdim=True))


def _maximum0(x):
    return torch.maximum(x, torch.zeros_like(x))


def _minimum0(x):
    return torch.minimum(x, torch.zeros_like(x))


# -- projection, stereo and epipolar factors ----------------------------------

def stereo_residual(xs, meas):
    """StereoFactor: (uL, uR, v) residual (reference: GenericStereoFactor,
    StereoCamera::project). meas: measured [3], cal [5] = (fx, fy, cx, cy,
    baseline)."""
    pose, point = xs
    fx, fy, cx, cy, b = meas["cal"].unbind(-1)
    pc = se3.transform_to(pose, point)
    z = pc[..., 2]
    z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    return torch.stack([fx * pc[..., 0] / z_safe + cx,
                        fx * (pc[..., 0] - b) / z_safe + cx,
                        fy * pc[..., 1] / z_safe + cy],
                       dim=-1) - meas["measured"]


def projection_residual(xs, meas):
    """GenericProjectionFactor<Pose3, Point3, Cal3_S2> with a fixed
    calibration (reference: slam/ProjectionFactor.h). meas: measured [2],
    cal [5]."""
    pose, point = xs
    return (cameras.project_point(pose, point, meas["cal"], "cal3_s2")
            - meas["measured"])


def essential_factor_residual(xs, meas):
    """EssentialMatrixFactor: epipolar error of a calibrated point pair
    (reference: slam/EssentialMatrixFactor.h)."""
    (e,) = xs
    return extra.essential_epipolar_error(e, meas["pA"], meas["pB"])


def frobenius_between_residual(xs, meas):
    """FrobeniusBetweenFactor<Rot3>: vec(R2 - R1 R12) (reference:
    slam/FrobeniusFactor.h)."""
    R1, R2 = xs
    return (R2 - R1 @ meas["R12"]).flatten(-2)


def pose_translation_prior_residual(xs, meas):
    """PoseTranslationPrior<Pose3> (reference:
    slam/PoseTranslationPrior.h)."""
    (pose,) = xs
    return se3.translation(pose) - meas["measured"]


def pose_rotation_prior_residual(xs, meas):
    """PoseRotationPrior<Pose3> (reference: slam/PoseRotationPrior.h)."""
    (pose,) = xs
    return so3.logmap(meas["measured"].transpose(-1, -2)
                      @ se3.rotation(pose))


# -- planar projection, rotation, frames and planes ---------------------------

def pose2_to_pose3(wTb):
    """Pose3::FromPose2: a planar pose [..., 3] in SE(3), z = 0, yaw
    only."""
    c, s = torch.cos(wTb[..., 2]), torch.sin(wTb[..., 2])
    z, o = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, -s, z], dim=-1),
                     torch.stack([s, c, z], dim=-1),
                     torch.stack([z, z, o], dim=-1)], dim=-2)
    return se3.make(R, torch.stack([wTb[..., 0], wTb[..., 1], z], dim=-1))


def _planar_project(landmark, wTb, bTc, calib):
    """The pixel of `landmark` seen by camera bTc on the planar body pose
    wTb through Cal3DS2 (reference: slam/PlanarProjectionFactor.h:57)."""
    wTc = se3.compose(pose2_to_pose3(wTb), bTc)
    return cameras.project_point(wTc, landmark, calib, "cal3ds2")


def planar_projection1_residual(xs, meas):
    """PlanarProjectionFactor1: unknown planar pose; landmark, offset and
    calibration known (reference: slam/PlanarProjectionFactor.h:109)."""
    (wTb,) = xs
    return (_planar_project(meas["landmark"], wTb, meas["bTc"],
                            meas["calib"]) - meas["measured"])


def planar_projection2_residual(xs, meas):
    """PlanarProjectionFactor2: unknown pose and landmark (reference:
    slam/PlanarProjectionFactor.h:171)."""
    wTb, landmark = xs
    return (_planar_project(landmark, wTb, meas["bTc"], meas["calib"])
            - meas["measured"])


def planar_projection3_residual(xs, meas):
    """PlanarProjectionFactor3: unknown pose, camera offset and calibration
    (reference: slam/PlanarProjectionFactor.h:237)."""
    wTb, bTc, calib = xs
    return (_planar_project(meas["landmark"], wTb, bTc, calib)
            - meas["measured"])


def rotate_residual(xs, meas):
    """RotateFactor: R z - p (reference: slam/RotateFactor.h:56)."""
    (R,) = xs
    return (R @ meas["z"][..., None])[..., 0] - meas["p"]


def rotate_directions_residual(xs, meas):
    """RotateDirectionsFactor: tangent error of iRc c_z at the measured
    direction i_p (reference: slam/RotateFactor.h:110)."""
    (iRc,) = xs
    i_q = (iRc @ meas["c_z"][..., None])[..., 0]
    return extra.unit3_local(meas["i_p"], i_q)


def make_reference_frame_residual(point_group: str = "point3",
                                  transform_group: str = "se3"):
    """ReferenceFrameFactor<Point, Transform>: transform_from(lTg, p_global)
    - p_local (reference: slam/ReferenceFrameFactor.h:43)."""
    tf = se3.transform_from if transform_group == "se3" else se2.transform_from

    def residual(xs, meas):
        p_global, lTg, p_local = xs
        return tf(lTg, p_global) - p_local

    residual.__name__ = f"reference_frame_{transform_group}"
    return residual


def oriented_plane3_residual(xs, meas):
    """OrientedPlane3Factor: the measured plane against the world plane in
    the sensor frame (reference: slam/OrientedPlane3Factor.h:49)."""
    pose, plane = xs
    return extra.plane_local(meas["measured"],
                             extra.plane_transform(plane, pose))


def oriented_plane3_direction_prior_residual(xs, meas):
    """OrientedPlane3DirectionPrior: prior on the plane's normal (reference:
    slam/OrientedPlane3Factor.h:82)."""
    (plane,) = xs
    return extra.unit3_local(meas["measured"][..., :3], plane[..., :3])


def make_bounding_constraint_residual(value_fn, is_greater_than: bool = True):
    """BoundingConstraint1-style one-sided hinge on the scalar
    value_fn(xs, meas) - meas['threshold'] (reference:
    slam/BoundingConstraint.h:78). Its closure holds `value_fn`, so a batch
    of it cannot be rebuilt from a name: register it
    (utils/serialization.py:register_residual) before loading one."""

    def residual(xs, meas):
        v = torch.atleast_1d(value_fn(xs, meas) - meas["threshold"])
        return _minimum0(v) if is_greater_than else _maximum0(v)

    return residual


def range_bound_residual(xs, meas):
    """The range between two planar poses stays below meas['threshold']
    (reference: testBoundingConstraint.cpp usage)."""
    a, b = xs
    d = _norm1(se2.translation(b) - se2.translation(a) + 1e-12)
    return _maximum0(d - meas["threshold"][..., None])


# -- transfer factors (reference: gtsam/sfm/TransferFactor.h) -----------------

def _maybe_t(M, flag):
    """M^T where the (bool or 0/1) flag is set."""
    return torch.where((flag != 0)[..., None, None], M.transpose(-1, -2), M)


def transfer_factor_residual(xs, meas):
    """TransferFactor<FundamentalMatrix>: pa, pb transferred into view c by
    two fundamental matrices, against pc (reference:
    sfm/TransferFactor.h:86); the transpose flags come from the edge keys,
    resolved on the host."""
    F1, F2 = xs
    Fca = _maybe_t(fundamental.fundamental_matrix(F1), meas["transpose1"])
    Fcb = _maybe_t(fundamental.fundamental_matrix(F2), meas["transpose2"])
    return (fundamental.epipolar_transfer(Fca, meas["pa"], Fcb, meas["pb"])
            - meas["pc"])


def essential_transfer_residual(xs, meas):
    """EssentialTransferFactor: the same transfer through essential-matrix
    variables and fixed calibrations Ka, Kb, Kc (reference:
    sfm/TransferFactor.h)."""
    E1, E2 = xs
    Kc_it = torch.linalg.inv(meas["Kc"]).transpose(-1, -2)
    F1 = Kc_it @ extra.essential_matrix(E1) @ torch.linalg.inv(meas["Ka"])
    F2 = Kc_it @ extra.essential_matrix(E2) @ torch.linalg.inv(meas["Kb"])
    Fca = _maybe_t(F1, meas["transpose1"])
    Fcb = _maybe_t(F2, meas["transpose2"])
    return (fundamental.epipolar_transfer(Fca, meas["pa"], Fcb, meas["pb"])
            - meas["pc"])


# -- the long-tail factors of gtsam_unstable/slam ------------------------------

_LOGMAPS = {"se2": se2.logmap, "se3": se3.logmap, "so2": so2.logmap,
            "so3": so3.logmap}


def make_partial_prior_residual(group: str, indices):
    """PartialPriorFactor: prior on the components `indices` of Logmap(x)
    (reference: gtsam_unstable/slam/PartialPriorFactor.h); meas['prior']
    holds those components. Its closure holds `indices`, so a batch of it
    cannot be rebuilt from a name: register it before loading one."""
    logmap = _LOGMAPS.get(group)
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64))

    def residual(xs, meas):
        (x,) = xs
        full = logmap(x) if logmap is not None else x.reshape(-1)
        return full[..., idx.to(full.device)] - meas["prior"]

    residual.__name__ = f"partial_prior_{group}"
    return residual


def relative_elevation_residual(xs, meas):
    """RelativeElevationFactor: pose.z - point.z - measured (reference:
    gtsam_unstable/slam/RelativeElevationFactor.cpp:22)."""
    pose, point = xs
    return (se3.translation(pose)[..., 2:3] - point[..., 2:3]
            - meas["measured"])


def essential_matrix_constraint_residual(xs, meas):
    """EssentialMatrixConstraint: the measured essential matrix against the
    one of p1.between(p2), 5-dim (reference:
    slam/EssentialMatrixConstraint.cpp:45-76)."""
    p1, p2 = xs
    rel = se3.between(p1, p2)
    t = se3.translation(rel)
    tn = t / torch.maximum(_norm1(t), torch.full_like(t[..., :1], 1e-12))
    hx = extra.essential_make(se3.rotation(rel), tn)
    measured = extra.essential_make(meas["measured_R"], meas["measured_t"])
    return extra.essential_local(measured, hx)


def projection_ppp_residual(xs, meas):
    """ProjectionFactorPPP: projection through wTb composed with an unknown
    bTc (reference: gtsam_unstable/slam/ProjectionFactorPPP.h)."""
    wTb, bTc, point = xs
    return (cameras.project_point(se3.compose(wTb, bTc), point, meas["cal"],
                                  "cal3_s2") - meas["measured"])


def _pose_module(group):
    return se3 if group == "se3" else se2


def make_between_sensor_residual(group: str = "se3"):
    """PoseBetweenFactor with a fixed body->sensor transform (reference:
    gtsam_unstable/slam/PoseBetweenFactor.h)."""
    m = _pose_module(group)

    def residual(xs, meas):
        a, b = xs
        sa = m.compose(a, meas["body_P_sensor"])
        sb = m.compose(b, meas["body_P_sensor"])
        return m.local(m.compose(sa, meas["measured"]), sb)

    residual.__name__ = f"between_sensor_{group}"
    return residual


def make_prior_sensor_residual(group: str = "se3"):
    """PosePriorFactor with a fixed body->sensor transform (reference:
    gtsam_unstable/slam/PosePriorFactor.h)."""
    m = _pose_module(group)

    def residual(xs, meas):
        (a,) = xs
        return m.local(meas["prior"], m.compose(a, meas["body_P_sensor"]))

    residual.__name__ = f"prior_sensor_{group}"
    return residual


def local_oriented_plane3_residual(xs, meas):
    """LocalOrientedPlane3Factor: the plane lives in an anchor frame and is
    seen from a second pose (reference:
    gtsam_unstable/slam/LocalOrientedPlane3Factor.h)."""
    pose, anchor, plane = xs
    rel = se3.compose(se3.inverse(anchor), pose)
    return extra.plane_local(meas["measured"],
                             extra.plane_transform(plane, rel))


# -- names ---------------------------------------------------------------------

_NAMED = {"bearing_range_2d": bearing_range_2d_residual,
          "range_2d": range_2d_residual,
          "pose_point_2d": pose_point_2d_residual,
          "pose_point_3d": pose_point_3d_residual,
          "stereo": stereo_residual,
          "projection": projection_residual,
          "essential_factor": essential_factor_residual,
          "frobenius_between": frobenius_between_residual,
          "pose_translation_prior": pose_translation_prior_residual,
          "pose_rotation_prior": pose_rotation_prior_residual,
          "planar_projection1": planar_projection1_residual,
          "planar_projection2": planar_projection2_residual,
          "planar_projection3": planar_projection3_residual,
          "rotate": rotate_residual,
          "rotate_directions": rotate_directions_residual,
          "oriented_plane3": oriented_plane3_residual,
          "oriented_plane3_direction_prior":
              oriented_plane3_direction_prior_residual,
          "range_bound": range_bound_residual,
          "transfer_factor": transfer_factor_residual,
          "essential_transfer": essential_transfer_residual,
          "relative_elevation": relative_elevation_residual,
          "essential_matrix_constraint":
              essential_matrix_constraint_residual,
          "projection_ppp": projection_ppp_residual,
          "local_oriented_plane3": local_oriented_plane3_residual,
          **unstable.NAMED, **nav.NAMED}

# factories whose closure holds only the group: "<prefix><group>"; the
# longer prefixes first, so that "between_sensor_se3" is not read as
# between_<"sensor_se3">
_FACTORIES = unstable.FACTORIES + [
             ("between_sensor_", make_between_sensor_residual),
              ("prior_sensor_", make_prior_sensor_residual),
              ("reference_frame_",
               lambda g: make_reference_frame_residual(
                   "point3" if g == "se3" else "point2", g)),
              ("prior_", make_prior_residual),
              ("between_", make_between_residual)]
# one function per factory name, so that the batches of a graph built by
# name share it (hybrid/hybrid.py merges batches of one function)
_MADE = {}
# factories whose closure holds more than the groups
_UNNAMEABLE = {"partial_prior_": "the component indices",
               "bounding_constraint": "the value function"}
# the groups each factory kind is driven over in residual_names()
_POSE_GROUPS = ("se2", "se3")
_GROUPS = ("so2", "se2", "so3", "se3", "point2", "point3", "unit3", "sim3",
           "essential", "oriented_plane3", "line3", "sim2", "fundamental",
           "simple_fundamental")
_BETWEEN_GROUPS = ("so2", "se2", "so3", "se3", "point2", "point3")


def residual_by_name(name: str):
    """The residual function of a batch named:
    - `prior_<group>` or `between_<group>` for a registered group;
    - `between_sensor_<g>`, `prior_sensor_<g>`, `reference_frame_<g>` and
      `between_em_<g>` (slam/unstable.py) for g in se2, se3;
    - one of the module-level residuals of this module and of
      slam/unstable.py, by its function name without `_residual`
      (`stereo`, `projection`, `toa`, ...);
    - a navigation or dynamics residual (navigation/factors.py:NAMED:
      `imu`, `gps`, `ahrs`, `velocity_constraint_trapezoidal`, ...).
    An `_anti` suffix, which `FactorBatch.negated` adds, is ignored. A
    factory's function is made once per name and returned again after.

    `partial_prior_<group>` and `bounding_constraint` raise ValueError: the
    closures of their factories hold more than a name says (the indices, the
    value function). Register such a residual explicitly
    (utils/serialization.py:register_residual)."""
    while name.endswith("_anti"):
        name = name[:-len("_anti")]
    if name in _NAMED:
        return _NAMED[name]
    for prefix, what in _UNNAMEABLE.items():
        if name.startswith(prefix):
            raise ValueError(
                f"a batch named {name!r} cannot be rebuilt from its name: "
                f"the closure of its factory holds {what}; register its "
                f"residual with register_residual({name!r}, fn)")
    for prefix, make in _FACTORIES:
        if name.startswith(prefix) and name[len(prefix):]:
            group = name[len(prefix):]
            try:
                manifolds.get(group)
            except KeyError:
                break
            if name not in _MADE:
                _MADE[name] = make(group)
            return _MADE[name]
    raise ValueError(f"no residual function is known for a batch named "
                     f"{name!r} (known: prior_<group>, between_<group>, "
                     f"between_sensor_<g>, prior_sensor_<g>, "
                     f"reference_frame_<g>, between_em_<g>, "
                     f"{', '.join(sorted(_NAMED))})")


def residual_names():
    """Every concrete name residual_by_name resolves that the factor
    breadth checks drive: the named residuals, prior_<g> over the geometry
    groups, between_<g> over the Lie groups and points, and the pose
    factories over se2 and se3."""
    names = set(_NAMED)
    names |= {f"prior_{g}" for g in _GROUPS}
    names |= {f"between_{g}" for g in _BETWEEN_GROUPS}
    for prefix in ("between_sensor_", "prior_sensor_", "reference_frame_",
                   "between_em_"):
        names |= {prefix + g for g in _POSE_GROUPS}
    return sorted(names)


# -- sugar for adding factors to a GraphBuilder -------------------------------

def add_prior(gb, group, i, prior, noise_dict):
    gb.add(f"prior_{group}", make_prior_residual(group), (group,),
           manifolds.get(group).dim, [i], {"prior": prior}, noise_dict)


def add_between(gb, group, i, j, measured, noise_dict):
    gb.add(f"between_{group}", make_between_residual(group), (group, group),
           manifolds.get(group).dim, [i, j], {"measured": measured},
           noise_dict)


def diag_noise(sigmas_arr):
    s = np.asarray(sigmas_arr, dtype=np.float64)
    w = np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 1e3)
    return {"kind": "diag", "data": w}


def full_info_noise(info):
    """Full information matrix -> sqrt-information upper factor (host)."""
    info = np.asarray(info, dtype=np.float64)
    info = 0.5 * (info + info.T)
    w, V = np.linalg.eigh(info)          # numerical PSD safety
    w = np.clip(w, 0.0, None)
    L = np.linalg.cholesky(V @ np.diag(w) @ V.T
                           + 1e-12 * np.eye(info.shape[0]))
    return {"kind": "full", "data": L.T}
