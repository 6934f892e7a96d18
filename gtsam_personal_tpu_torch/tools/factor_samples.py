"""Seeded batches of factors for every residual that `residual_by_name`
knows, as numpy arrays: the inputs of the factor breadth checks.

    sample(name, K, seed) -> {"groups", "rdim", "points", "meas"}

`points` holds one array [K, *param_shape] per slot (variable k of slot s
is points[s][k], so the index table is arange(K) for every slot) and `meas`
the measurements [K, ...]. The inputs are drawn away from each factor's
singular set: cameras see their points at depths of 4-8 m, a measured
direction or plane lies near its prediction (a unit-vector chart is
singular at the antipode), scales are near 1. tests/test_torch_factors_
breadth.py feeds the same arrays to the JAX package and to the port at a
small K; chip_smoke.py phase 13 linearizes 4096 of each on the card and on
the CPU.

The arrays are made with the port's geometry in float64 on the CPU, so the
module needs no other package.
"""

import numpy as np
import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.geometry import (extra, fundamental, se2, se3,
                                               so3)
from gtsam_personal_tpu_torch.navigation import navstate, preintegration as pre
from gtsam_personal_tpu_torch.slam import factors as F


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _n(x):
    return x.detach().cpu().numpy()


class _Draw:
    """Random elements of each group, K at a time."""

    def __init__(self, K, seed):
        self.K = K
        self.rng = np.random.default_rng(seed)

    def normal(self, *shape, scale=1.0):
        return scale * self.rng.normal(size=(self.K,) + shape)

    def uniform(self, lo, hi, *shape):
        return self.rng.uniform(lo, hi, size=(self.K,) + shape)

    def rot(self, scale=0.5):
        return _n(so3.expmap(_t(self.normal(3, scale=scale))))

    def pose3(self, rot=0.5, trans=2.0):
        return _n(se3.expmap(_t(np.concatenate(
            [self.normal(3, scale=rot), self.normal(3, scale=trans)], 1))))

    def pose2(self):
        return np.concatenate([self.normal(2, scale=2.0),
                               self.uniform(-np.pi, np.pi, 1)], 1)

    def unit(self, near=None, spread=0.1):
        """Random unit vectors, or unit vectors at an angle of 0.3-1.0 times
        `spread` from `near` (never closer: the chart of a direction takes
        arccos of a cosine, which loses digits as the angle shrinks)."""
        if near is None:
            v = self.normal(3)
            return v / np.linalg.norm(v, axis=1, keepdims=True)
        n = near / np.linalg.norm(near, axis=1, keepdims=True)
        w = np.cross(n, self.normal(3))
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        w *= self.away(1, spread)
        return _n(so3.rotate(so3.expmap(_t(w)), _t(n)))

    def away(self, d, scale):
        """[K, d] with every component of magnitude 0.3-1.0 times scale and
        a random sign: perturbations kept off every guard and every
        cancellation near zero."""
        return (scale * self.uniform(0.3, 1.0, d)
                * np.where(self.rng.uniform(size=(self.K, d)) < 0.5, -1, 1))

    def plane(self):
        return np.concatenate([self.unit(), self.uniform(0.5, 3.0, 1)], 1)

    def near(self, group, x, scale=0.05):
        """x retracted by a small tangent whose every component is 0.3-1.0
        times scale in magnitude."""
        m = manifolds.get(group)
        return _n(manifolds.batched_retract(
            m, _t(x), _t(self.away(m.dim, scale))))

    def element(self, group):
        if group == "so2":
            return self.uniform(-np.pi, np.pi)
        if group == "se2":
            return self.pose2()
        if group == "so3":
            return self.rot()
        if group == "se3":
            return self.pose3()
        if group in ("point2", "point3"):
            return self.normal(int(group[-1]), scale=2.0)
        if group == "unit3":
            return self.unit()
        if group == "oriented_plane3":
            return self.plane()
        if group == "sim3":
            return _n(extra.sim3_expmap(_t(np.concatenate(
                [self.normal(3, scale=0.5), self.normal(3),
                 self.normal(1, scale=0.2)], 1))))
        if group == "essential":
            return _n(extra.essential_make(_t(self.rot()),
                                           _t(self.unit())))
        if group == "line3":
            return _n(extra.line3_make(_t(self.rot()), _t(self.normal()),
                                       _t(self.normal())))
        if group == "sim2":
            return np.concatenate([self.normal(2), self.uniform(-3, 3, 1),
                                   self.uniform(0.5, 2.0, 1)], 1)
        if group == "fundamental":
            return _n(fundamental.fundamental_make(
                _t(self.rot()), _t(self.uniform(0.2, 0.9, 1)),
                _t(self.rot())))
        if group == "simple_fundamental":
            return _n(fundamental.simple_fundamental_make(
                _t(self.element("essential")), _t(self.uniform(400, 600)),
                _t(self.uniform(400, 600)), _t(self.normal(2, scale=20)),
                _t(self.normal(2, scale=20))))
        raise KeyError(group)

    # -- cameras ------------------------------------------------------------
    def seen_point(self, pose):
        """World points at depth 4-8 m in front of camera-to-world poses."""
        pc = np.concatenate([self.normal(2, scale=0.5),
                             self.uniform(4.0, 8.0, 1)], 1)
        return _n(se3.transform_from(_t(pose), _t(pc)))

    def cal_s2(self):
        return np.concatenate([self.uniform(400, 600, 2),
                               self.normal(1, scale=1.0),
                               self.uniform(300, 340, 1),
                               self.uniform(220, 260, 1)], 1)

    def cal_ds2(self):
        return np.concatenate([self.cal_s2(), self.normal(2, scale=1e-2),
                               self.normal(2, scale=1e-3)], 1)

    def pixels(self):
        return self.uniform(100, 500, 2)

    def K3(self):
        c = self.cal_s2()
        K = np.zeros((self.K, 3, 3))
        K[:, 0, 0], K[:, 1, 1], K[:, 0, 1] = c[:, 0], c[:, 1], c[:, 2]
        K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = c[:, 3], c[:, 4], 1.0
        return K

    def flags(self):
        return (self.rng.uniform(size=self.K) < 0.5).astype(np.float64)


def _between_np(group, a, b):
    m = {"so2": lambda x, y: y - x, "se2": se2.between, "so3": so3.between,
         "se3": se3.between}.get(group, lambda x, y: y - x)
    return _n(m(_t(a), _t(b)))


def _inv_depth(ray):
    """(theta, phi, rho) of rays [K, 3]."""
    d = np.linalg.norm(ray, axis=1)
    return np.stack([np.arctan2(ray[:, 1], ray[:, 0]),
                     np.arcsin(ray[:, 2] / d), 1.0 / d], 1)


def _cal_pose_point(D):
    pose = D.pose3()
    return pose, D.seen_point(pose)


def _spec(name, D):
    """(groups, points, meas) of `name`, K factors."""
    K = D.K
    if name.startswith("prior_sensor_") or name.startswith("between_sensor_"):
        g = name.rsplit("_", 1)[1]
        m = se3 if g == "se3" else se2
        bPs = D.element(g)
        a, b = D.element(g), D.element(g)
        sa = _n(m.compose(_t(a), _t(bPs)))
        if name.startswith("prior_sensor_"):
            return (g,), [a], {"body_P_sensor": bPs,
                               "prior": D.near(g, sa)}
        sb = _n(m.compose(_t(b), _t(bPs)))
        return (g, g), [a, b], {"body_P_sensor": bPs,
                                "measured": D.near(g, _between_np(g, sa, sb))}
    if name.startswith("between_em_"):
        g = name.rsplit("_", 1)[1]
        a, b = D.element(g), D.element(g)
        d = manifolds.get(g).dim
        return (g, g), [a, b], {
            "measured": D.near(g, _between_np(g, a, b), 0.2),
            "w_in": D.uniform(5.0, 20.0, d), "w_out": D.uniform(0.1, 1.0, d),
            "prior_in": D.uniform(0.6, 0.95), "prior_out": D.uniform(0.05, 0.4)}
    if name.startswith("reference_frame_"):
        g = name.rsplit("_", 1)[1]
        pg = "point3" if g == "se3" else "point2"
        return (pg, g, pg), [D.element(pg), D.element(g), D.element(pg)], {}
    if name.startswith("prior_"):
        g = name[len("prior_"):]
        x = D.element(g)
        return (g,), [x], {"prior": D.near(g, x, 0.1)}
    if name.startswith("between_"):
        g = name[len("between_"):]
        a, b = D.element(g), D.element(g)
        meas = _between_np(g, a, b)
        return (g, g), [a, b], {"measured": D.near(g, meas, 0.1)}
    if name == "bearing_range_2d":
        return ("se2", "point2"), [D.pose2(), D.normal(2, scale=5.0)], {
            "bearing": D.uniform(-np.pi, np.pi), "range": D.uniform(1, 8)}
    if name == "range_2d":
        return ("se2", "point2"), [D.pose2(), D.normal(2, scale=5.0)], {
            "range": D.uniform(1, 8)}
    if name == "pose_point_2d":
        return ("se2", "point2"), [D.pose2(), D.normal(2, scale=5.0)], {
            "measured": D.normal(2)}
    if name == "pose_point_3d":
        return ("se3", "point3"), [D.pose3(), D.normal(3, scale=5.0)], {
            "measured": D.normal(3)}
    if name == "bearing_s2":
        pose, point = _cal_pose_point(D)
        pb = _n(se3.transform_to(_t(pose), _t(point)))
        return ("se3", "point3"), [pose, point], {
            "measured": D.unit(pb / np.linalg.norm(pb, axis=1,
                                                   keepdims=True))}
    if name in ("projection", "stereo"):
        pose, point = _cal_pose_point(D)
        if name == "projection":
            return ("se3", "point3"), [pose, point], {
                "measured": D.pixels(), "cal": D.cal_s2()}
        cal = np.concatenate([D.uniform(400, 600, 2), D.uniform(300, 340, 1),
                              D.uniform(220, 260, 1), D.uniform(0.05, 0.2, 1)],
                             1)
        return ("se3", "point3"), [pose, point], {
            "measured": D.uniform(100, 500, 3), "cal": cal}
    if name == "projection_ppp":
        wTb, bTc = D.pose3(), D.pose3(0.1, 0.2)
        point = D.seen_point(_n(se3.compose(_t(wTb), _t(bTc))))
        return ("se3", "se3", "point3"), [wTb, bTc, point], {
            "measured": D.pixels(), "cal": D.cal_s2()}
    if name == "projection_rolling_shutter":
        a = D.pose3()
        b = D.near("se3", a, 0.05)
        return ("se3", "se3", "point3"), [a, b, D.seen_point(a)], {
            "measured": D.pixels(), "alpha": D.uniform(0, 1),
            "cal": D.cal_s2()}
    if name in ("inv_depth_variant1", "inv_depth_variant2"):
        pose, point = _cal_pose_point(D)
        anchor = point + D.normal(3, scale=0.5) + 3.0 * D.unit()
        lm = _inv_depth(point - anchor)
        meas = {"measured": D.pixels(), "cal": D.cal_s2()}
        if name == "inv_depth_variant1":
            return ("se3", "r6"), [pose, np.concatenate([anchor, lm], 1)], meas
        return ("se3", "r3"), [pose, lm], dict(meas, anchor=anchor)
    if name == "inv_depth_variant3":
        pose_a, (pose_b, point) = D.pose3(), _cal_pose_point(D)
        lm = _inv_depth(_n(se3.transform_to(_t(pose_a), _t(point))))
        return ("se3", "se3", "r3"), [pose_a, pose_b, lm], {
            "measured": D.pixels(), "cal": D.cal_s2()}
    if name.startswith("planar_projection"):
        wTb = D.pose2()
        bTc = D.pose3(0.3, 0.3)
        wTc = _n(se3.compose(F.pose2_to_pose3(_t(wTb)), _t(bTc)))
        landmark, calib = D.seen_point(wTc), D.cal_ds2()
        meas = {"measured": D.pixels()}
        if name == "planar_projection1":
            return ("se2",), [wTb], dict(meas, landmark=landmark, bTc=bTc,
                                         calib=calib)
        if name == "planar_projection2":
            return ("se2", "point3"), [wTb, landmark], dict(meas, bTc=bTc,
                                                            calib=calib)
        return ("se2", "se3", "r9"), [wTb, bTc, calib], dict(
            meas, landmark=landmark)
    if name == "essential_factor":
        return ("essential",), [D.element("essential")], {
            "pA": D.normal(2, scale=0.3), "pB": D.normal(2, scale=0.3)}
    if name == "essential_matrix_constraint":
        p1, p2 = D.pose3(), D.pose3()
        rel = _n(se3.between(_t(p1), _t(p2)))
        t = rel[:, :, 3] / np.linalg.norm(rel[:, :, 3], axis=1,
                                          keepdims=True)
        return ("se3", "se3"), [p1, p2], {
            "measured_R": D.near("so3", rel[:, :, :3]),
            "measured_t": D.unit(t)}
    if name == "frobenius_between":
        return ("so3", "so3"), [D.rot(), D.rot()], {"R12": D.rot()}
    if name == "pose_translation_prior":
        return ("se3",), [D.pose3()], {"measured": D.normal(3)}
    if name == "pose_rotation_prior":
        pose = D.pose3()
        return ("se3",), [pose], {"measured": D.near("so3", pose[:, :, :3])}
    if name == "rotate":
        return ("so3",), [D.rot()], {"z": D.normal(3), "p": D.normal(3)}
    if name == "rotate_directions":
        R, cz = D.rot(), D.unit()
        return ("so3",), [R], {"c_z": cz, "i_p": D.unit(
            np.einsum("kij,kj->ki", R, cz))}
    if name in ("oriented_plane3", "local_oriented_plane3"):
        pose, plane = D.pose3(), D.plane()
        if name == "oriented_plane3":
            rel, groups, pts = pose, ("se3", "oriented_plane3"), [pose, plane]
        else:
            anchor = D.pose3()
            rel = _n(se3.compose(se3.inverse(_t(anchor)), _t(pose)))
            groups = ("se3", "se3", "oriented_plane3")
            pts = [pose, anchor, plane]
        pred = _n(extra.plane_transform(_t(plane), _t(rel)))
        return groups, pts, {"measured": D.near("oriented_plane3", pred)}
    if name == "oriented_plane3_direction_prior":
        plane = D.plane()
        return ("oriented_plane3",), [plane], {
            "measured": D.near("oriented_plane3", plane)}
    if name == "range_bound":
        a, b = D.pose2(), D.pose2()
        d = np.linalg.norm(b[:, :2] - a[:, :2], axis=1)
        # half of them violate the bound, half keep it
        return ("se2", "se2"), [a, b], {
            "threshold": d * np.where(D.flags() > 0, 0.7, 1.3)}
    if name == "relative_elevation":
        return ("se3", "point3"), [D.pose3(), D.normal(3)], {
            "measured": D.normal(1)}
    if name in ("transfer_factor", "essential_transfer"):
        g = "fundamental" if name == "transfer_factor" else "essential"
        meas = {"pa": D.pixels(), "pb": D.pixels(), "pc": D.pixels(),
                "transpose1": D.flags(), "transpose2": D.flags()}
        if g == "essential":
            meas.update(Ka=D.K3(), Kb=D.K3(), Kc=D.K3())
        return (g, g), [D.element(g), D.element(g)], meas
    if name in ("toa", "toa2"):
        event = np.concatenate([D.uniform(0, 1, 1), D.normal(3, scale=5.0)], 1)
        sensor = D.normal(3, scale=5.0)
        meas = {"toa": D.uniform(0.0, 0.2),
                "speed": np.full(K, 330.0)}
        if name == "toa":
            return ("event",), [event], dict(meas, sensor=sensor)
        return ("event", "point3"), [event, sensor], meas
    nav = _nav_spec(name, D)
    if nav is None:
        raise KeyError(name)
    return nav


def _imu_case(D, combined):
    """A PIM's arrays and (pose_i, vel_i) with (pose_j, vel_j) near the
    state that the PIM predicts from them."""
    K = D.K
    pose_i, vel_i = D.pose3(), D.normal(3, scale=2.0)
    bias_hat = D.normal(6, scale=0.01)
    bias = bias_hat + D.normal(6, scale=0.01)
    meas = {"zeta": np.concatenate([D.normal(3, scale=0.2), D.normal(3),
                                    D.normal(3)], 1),
            "H_ba": D.normal(9, 3, scale=0.1),
            "H_bw": D.normal(9, 3, scale=0.1), "bias_hat": bias_hat,
            "deltaT": D.uniform(0.1, 1.0),
            "gravity": np.tile([0.0, 0.0, -9.81], (K, 1))}
    pim = pre.PIM(_t(meas["zeta"]), _t(meas["H_ba"]), _t(meas["H_bw"]),
                  None, _t(bias_hat), _t(meas["deltaT"]))
    pred = pre.predict(pim, pre.PreintegrationParams(
        _t(meas["gravity"]), None, None, None),
        navstate.from_pose_vel(_t(pose_i), _t(vel_i)), _t(bias))
    pose_j = D.near("se3", _n(navstate.pose_of(pred)))
    vel_j = _n(navstate.velocity(pred)) + D.away(3, 0.05)
    groups = ("se3", "vel3", "se3", "vel3", "imu_bias")
    points = [pose_i, vel_i, pose_j, vel_j, bias]
    if combined:
        groups += ("imu_bias",)
        points.append(bias + D.normal(6, scale=0.01))
    return groups, points, meas


def _nav_spec(name, D):
    """(groups, points, meas) of a navigation or dynamics residual, or
    None."""
    if name in ("imu", "combined_imu"):
        return _imu_case(D, name == "combined_imu")
    if name == "ahrs":
        Ri = D.rot()
        theta, H = D.normal(3, scale=0.2), D.normal(3, 3, scale=0.3)
        bias_hat = D.normal(3, scale=0.01)
        bias = bias_hat + D.normal(3, scale=0.01)
        corr = theta + np.einsum("kij,kj->ki", H, bias - bias_hat)
        Rj = D.near("so3", _n(_t(Ri) @ so3.expmap(_t(corr))))
        return ("so3", "so3", "r3"), [Ri, Rj, bias], {
            "theta": theta, "H_bw": H, "bias_hat": bias_hat}
    if name in ("gps", "biased_gps"):
        if name == "gps":
            return ("se3",), [D.pose3()], {"measured": D.normal(3)}
        return ("se3", "r3"), [D.pose3(), D.normal(3)], {
            "measured": D.normal(3)}
    if name == "attitude":
        pose, bRef = D.pose3(), D.unit()
        return ("se3",), [pose], {"bRef": bRef, "nZ": D.unit(
            np.einsum("kij,kj->ki", pose[:, :, :3], bRef))}
    if name == "constant_velocity":
        return ("vel3", "vel3"), [D.normal(3), D.normal(3)], {}
    if name == "barometric":
        return ("se3", "r1"), [D.pose3(), D.normal(1)], {
            "height": D.normal(1)[:, 0]}
    if name in ("mag_rot3", "mag_pose"):
        x = D.rot() if name == "mag_rot3" else D.pose3()
        return ("so3",) if name == "mag_rot3" else ("se3",), [x], {
            "nM": D.normal(3, scale=20.0), "bias": D.normal(3),
            "measured": D.normal(3, scale=20.0)}
    if name == "mag_field_bias":
        return ("r3", "r3"), [D.normal(3, scale=20.0), D.normal(3)], {
            "bRn": D.rot(), "measured": D.normal(3, scale=20.0)}
    if name == "mag_scale_dir_bias":
        return ("r1", "unit3", "r3"), [D.uniform(0.5, 2.0, 1), D.unit(),
                                       D.normal(3)], {
            "bRn": D.rot(), "measured": D.normal(3)}
    if name == "gauss_markov":
        return ("r3", "r3"), [D.normal(3), D.normal(3)], {
            "dt": D.uniform(0.1, 1.0), "tau": D.uniform(1.0, 10.0, 3)}
    if name.startswith("velocity_constraint_"):
        return ("se3", "vel3", "se3", "vel3"), [
            D.pose3(), D.normal(3), D.pose3(), D.normal(3)], {
            "dt": D.uniform(0.1, 1.0)}
    scalars = {"h": D.uniform(0.01, 0.1), "m": D.uniform(0.5, 2.0),
               "r": D.uniform(0.5, 2.0), "g": D.uniform(9.0, 10.0),
               "alpha": D.uniform(0.0, 1.0)}
    keys = {"velocity_constraint3": (), "pendulum1": ("h",),
            "pendulum2": ("h", "g", "r"),
            "pendulum_pk": ("h", "m", "r", "g", "alpha"),
            "pendulum_pk1": ("h", "m", "r", "g", "alpha")}.get(name)
    if keys is None:
        return None
    meas = {k: scalars[k] for k in keys}
    if name == "velocity_constraint3":
        meas["dt"] = D.uniform(0.1, 1.0)
    return ("r1", "r1", "r1"), [D.normal(1), D.normal(1), D.normal(1)], meas


def sample(name: str, K: int, seed: int = 0):
    """The seeded inputs of K factors of the batch name `name` (one of
    slam/factors.py:residual_names())."""
    D = _Draw(K, seed)
    groups, points, meas = _spec(name, D)
    fn = F.residual_by_name(name)
    r = fn(tuple(_t(p[0]) for p in points),
           {k: _t(v[0]) for k, v in meas.items()})
    return {"groups": tuple(groups), "rdim": int(r.shape[-1]),
            "points": [np.ascontiguousarray(p, dtype=np.float64)
                       for p in points],
            "meas": {k: np.ascontiguousarray(v, dtype=np.float64)
                     for k, v in meas.items()}}
