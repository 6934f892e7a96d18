"""The port's triangulation and smart factors (geometry/triangulation.py,
sfm/smart.py, tools/isam2_smart_factor.py) against the JAX package's,
float64 on the CPU, from the same numpy inputs.

The residuals' Jacobians are taken with respect to the entries of the pose
matrices, `vmap` over factors of `jacfwd` in both packages (linearize's form
without the retraction), tolerance rtol 1e-9 with an atol of 1e-9 times the
largest entry. The tool at its defaults runs beside the JAX example
(examples/isam2_smart_factor.py, loaded by path and run on the CPU in
float64) on the same scene: its stream's CG stops at 25 iterations or 1e-4
of the entry residual, so the two streams agree to rounding amplified by
that stop, not to the last digit.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.geometry import triangulation as jtri
from gtsam_personal_tpu.nonlinear import isam2 as jisam2
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.sfm import smart as jsm
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.geometry import se3, so3
from gtsam_personal_tpu_torch.geometry import triangulation as tri
from gtsam_personal_tpu_torch.linear.linearize import linearize_batch
from gtsam_personal_tpu_torch.sfm import smart
from gtsam_personal_tpu_torch.tools import isam2_smart_factor as tool

T, K = 4, 3
RTOL = 1e-9


def close(got, ref, what="", rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def tracks(seed=0, k=K, n=T, noise=0.01):
    """k tracks of n cameras on a ring looking at a point near the origin:
    poses [k, n, 3, 4], unit-plane measurements [k, n, 2], points [k, 3]."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((k, n, 3, 4))
    for i in range(k):
        for c in range(n):
            th = 0.4 * c + 1.3 * i
            eye = np.array([10 * np.cos(th), 10 * np.sin(th),
                            1.0 + 0.3 * c])
            zc = -eye / np.linalg.norm(eye)
            xc = np.cross(zc, [0.0, 0.0, 1.0])
            xc /= np.linalg.norm(xc)
            poses[i, c] = np.concatenate(
                [np.stack([xc, np.cross(zc, xc), zc], 1), eye[:, None]], 1)
    pts = rng.uniform(-2, 2, size=(k, 3))
    pc = se3.transform_to(t(poses), t(pts)[:, None]).numpy()
    uv = pc[..., :2] / pc[..., 2:3] + rng.normal(scale=noise, size=(k, n, 2))
    return poses, uv, pts


# -- triangulation -------------------------------------------------------------

def test_dlt_and_lost_match_jax():
    poses, uv, pts = tracks()
    for i in range(K):
        p, deg = tri.triangulate_dlt(t(poses[i]), t(uv[i]))
        jp, jdeg = jtri.triangulate_dlt(jnp.asarray(poses[i]),
                                        jnp.asarray(uv[i]))
        close(p.numpy(), jp, "dlt")
        assert bool(deg) == bool(jdeg) is False
        q, qdeg = tri.triangulate_lost(t(poses[i]), t(uv[i]))
        jq, jqdeg = jtri.triangulate_lost(jnp.asarray(poses[i]),
                                          jnp.asarray(uv[i]))
        close(q.numpy(), jq, "lost")
        assert bool(qdeg) == bool(jqdeg)
        assert np.linalg.norm(p.numpy() - pts[i]) < 0.5


def test_refine_and_implicit_refine_match_jax():
    """Value and derivative in the poses of both refinements: the unrolled
    iterations and the implicit-function-theorem tangent."""
    poses, uv, _ = tracks(seed=1)
    P, U = poses[0], uv[0]
    p0 = np.asarray(jtri.triangulate_dlt(jnp.asarray(P), jnp.asarray(U))[0])
    for name, tf, jf in (("refine", tri.refine_nonlinear,
                          jtri.refine_nonlinear),
                         ("implicit", tri.refine_nonlinear_implicit,
                          jtri.refine_nonlinear_implicit)):
        close(tf(t(P), t(U), t(p0), 3).numpy(),
              jf(jnp.asarray(P), jnp.asarray(U), jnp.asarray(p0), iters=3),
              name)
        J = torch.func.jacfwd(lambda x: tf(x, t(U), t(p0), 3))(t(P))
        jJ = jax.jit(jax.jacfwd(lambda x: jf(x, jnp.asarray(U),
                                             jnp.asarray(p0), iters=3)))(
            jnp.asarray(P))
        close(J.numpy(), jJ, name + " d/dposes")


def test_triangulate_safe_flags():
    poses, uv, _ = tracks(seed=2, k=1)
    P, U = t(poses[0]), t(uv[0])
    r = tri.triangulate_safe(P, U)
    jr = jtri.triangulate_safe(jnp.asarray(poses[0]), jnp.asarray(uv[0]))
    close(r.point.numpy(), jr.point, "point")
    assert (bool(r.valid), bool(r.degenerate), bool(r.behind)) == (
        True, False, False) == tuple(map(bool, (jr.valid, jr.degenerate,
                                                jr.behind)))
    # one camera and one ray seen T times: the DLT system has rank 2
    same, Us = P[:1].expand(T, 3, 4), U[:1].expand(T, 2)
    r = tri.triangulate_safe(same, Us)
    jr = jtri.triangulate_safe(jnp.asarray(same.numpy()),
                               jnp.asarray(Us.numpy()))
    assert bool(r.degenerate) and not bool(r.valid)
    assert bool(jr.degenerate) and not bool(jr.valid)
    # the point behind the cameras: flip every camera to look away
    back = P.clone()
    back[:, :, :3] = P[:, :, :3] @ so3.expmap(t([0.0, np.pi, 0.0]))
    r = tri.triangulate_safe(back, U)
    jr = jtri.triangulate_safe(jnp.asarray(back.numpy()), jnp.asarray(uv[0]))
    assert bool(r.behind) == bool(jr.behind) is True
    assert not bool(r.valid)
    close(tri.pixels_to_unit(t([[320.0, 250.0]]), (500, 480, 300, 240)),
          jtri.pixels_to_unit(jnp.asarray([[320.0, 250.0]]),
                              (500, 480, 300, 240)), "pixels_to_unit")


# -- smart residuals -------------------------------------------------------------

def _jac_both(tfn, jfn, poses, meas):
    """vmap over factors of (residual, d residual / d pose entries) in both
    packages."""
    def tone(P, m):
        return tfn(tuple(P), m)

    def jone(P, m):
        return jfn(tuple(P), m)
    tm = {k: t(v) for k, v in meas.items()}
    jm = {k: jnp.asarray(v) for k, v in meas.items()}
    tr = torch.func.vmap(tone)(t(poses), tm)
    tJ = torch.func.vmap(torch.func.jacfwd(tone))(t(poses), tm)
    jr, jJ = jax.jit(jax.vmap(lambda P, m: (jone(P, m),
                                            jax.jacfwd(jone)(P, m))))(
        jnp.asarray(poses), jm)
    return tr, tJ, jr, jJ


@pytest.mark.parametrize("implicit", [True, False])
def test_smart_residual_matches_jax(implicit):
    poses, uv, _ = tracks(seed=3)
    tr, tJ, jr, jJ = _jac_both(smart.make_smart_residual(T,
                                                         implicit=implicit),
                               jsm.make_smart_residual(T, implicit=implicit),
                               poses, {"uv": uv})
    close(tr.numpy(), jr, "residual")
    close(tJ.numpy(), jJ, "Jacobian")
    assert np.abs(tr.numpy()).max() > 0      # no track was zero-weighted


def test_smart_stereo_residual_matches_jax():
    poses, uv, pts = tracks(seed=4)
    cal = np.array([500.0, 480.0, 320.0, 240.0, 0.12])
    pc = se3.transform_to(t(poses), t(pts)[:, None]).numpy()
    uvs = smart._stereo_project(t(poses), t(pts)[:, None],
                                t(cal)).numpy()
    uvs += np.random.default_rng(4).normal(scale=0.5, size=uvs.shape)
    assert (pc[..., 2] > 0).all()
    tr, tJ, jr, jJ = _jac_both(smart.make_smart_stereo_residual(T),
                               jsm.make_smart_stereo_residual(T), poses,
                               {"uvs": uvs, "cal": np.tile(cal, (K, 1))})
    close(tr.numpy(), jr, "residual")
    close(tJ.numpy(), jJ, "Jacobian")


def test_smart_rig_residual_matches_jax():
    poses, uv, pts = tracks(seed=5)
    rng = np.random.default_rng(5)
    bTc = se3.expmap(t(np.concatenate([0.05 * rng.normal(size=(2, 3)),
                                       0.2 * rng.normal(size=(2, 3))], 1)))
    cal = np.array([[500.0, 480.0, 0.5, 320.0, 240.0],
                    [450.0, 450.0, 0.0, 310.0, 250.0]])
    cams = rng.integers(0, 2, size=(K, T))
    # bodies whose cameras are the ring's cameras: wTb = wTc bTc^-1
    bodies = se3.compose(t(poses), se3.inverse(bTc[cams])).numpy()
    from gtsam_personal_tpu_torch.geometry import cameras
    px = cameras.project_point(t(poses), t(pts)[:, None], t(cal[cams]),
                               "cal3_s2").numpy()
    px += rng.normal(scale=0.5, size=px.shape)
    meas = {"uv": px, "bTc": bTc[cams].numpy(), "cal": cal[cams]}
    tr, tJ, jr, jJ = _jac_both(smart.make_smart_rig_residual(T),
                               jsm.make_smart_rig_residual(T), bodies, meas)
    close(tr.numpy(), jr, "residual")
    close(tJ.numpy(), jJ, "Jacobian")


def test_build_smart_batches():
    """The builders group by track length (dropping what the JAX package
    drops), and a batch linearizes through the implicit triangulation."""
    poses, uv, _ = tracks(seed=6)
    ring = poses.reshape(-1, 3, 4)
    trk = [list(range(i * T, i * T + T)) for i in range(K)] + [[0, 5, 9]]
    meas = [uv[i] for i in range(K)] + [uv[0, :3]]
    bs = smart.build_smart_batches(trk + [[1]], meas + [uv[0, :1]],
                                   sigma=0.5, device="cpu")
    assert [(b.name, b.size, b.rdim) for b in bs] == [
        ("smart_projection_T3", 1, 6), ("smart_projection_T4", K, 8)]
    lin = linearize_batch(bs[1], Values({"se3": t(ring)}))
    assert lin.r.shape == (K, 8) and all(J.shape == (K, 8, 6)
                                         for J in lin.Js)
    close(lin.r.numpy(), 2.0 * torch.func.vmap(
        smart.make_smart_residual(T))(tuple(t(poses).unbind(1)),
                                      {"uv": t(uv)}).numpy(), "whitened")
    st = smart.build_smart_stereo_batches(
        trk[:K], [np.zeros((T, 3))] * K, np.ones(5), device="cpu")
    assert [(b.name, b.size, b.rdim) for b in st] == [("smart_stereo_T4", K,
                                                       12)]
    rig = smart.build_smart_rig_batches(
        trk[:K], [np.zeros((T, 2))] * K, [[0, 1, 0, 1]] * K,
        np.stack([np.eye(3, 4)] * 2), np.ones((2, 5)), device="cpu")
    assert rig[0].meas["bTc"].shape == (K, T, 3, 4)


# -- the tool ----------------------------------------------------------------------

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_isam2_smart_factor",
        Path(__file__).resolve().parents[1] / "examples" /
        "isam2_smart_factor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_isam2_smart_factor_tool_matches_jax_example(monkeypatch):
    """The example's main() at its defaults (12 poses, 30 landmarks), its
    engine and batch result captured, against the tool's run()."""
    got = {}

    class Captured(jisam2.ISAM2):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            got["isam"] = self
    orig = jopt.optimize_lm

    def capture(*a, **k):
        got["batch"] = orig(*a, **k)
        return got["batch"]
    monkeypatch.setattr(jisam2, "ISAM2", Captured)
    monkeypatch.setattr(jopt, "optimize_lm", capture)
    monkeypatch.setattr("sys.argv", ["isam2_smart_factor"])
    assert _jax_example().main() == 0
    jest = got["isam"].estimate_array("se3")
    jb = np.asarray(got["batch"].values["se3"])

    out = tool.run(device="cpu", say=lambda *_: None)
    assert out["ok"] and out["n_smart"] == 30
    assert out["batch"].iterations == got["batch"].iterations
    np.testing.assert_allclose(out["batch"].error, got["batch"].error,
                               rtol=1e-9)
    close(out["batch"].values["se3"].numpy(), jb, "batch solution")
    est = out["isam"].estimate_array("se3")
    np.testing.assert_allclose(out["isam"].error(), got["isam"].error(),
                               rtol=1e-7)
    np.testing.assert_allclose(est, jest, rtol=0, atol=1e-5)
    poses = tool.make_scene(12, 30, 4, 0.002)[0]
    pos_err = np.linalg.norm(jest[:, :, 3] - poses[:, :, 3], axis=1).mean()
    dpos = np.linalg.norm(jest[:, :, 3] - jb[:, :, 3], axis=1).max()
    np.testing.assert_allclose(out["pos_err"], pos_err, rtol=1e-4)
    np.testing.assert_allclose(out["dpos"], dpos, rtol=1e-4)
