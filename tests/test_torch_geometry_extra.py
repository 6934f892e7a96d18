"""The port's geometry/extra.py, geometry/fundamental.py and the calibrations
of geometry/cameras.py against the JAX package's, float64 on the CPU.

The same seeded numpy arrays go through `jax.vmap` of the JAX function and
through the port's batched function. Tolerance: rtol 1e-12 with an atol of
1e-12 times the largest entry compared (an entry that cancels to rounding
agrees in no relative digit). The guards are tested where they bite: at
coincidence (n == m, a zero tangent) and just below each small-angle
threshold, values and forward-mode Jacobians, since the JAX package's
Jacobians are the reference there too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core import manifolds as jman
from gtsam_personal_tpu.geometry import cameras as jcam, extra as jex
from gtsam_personal_tpu.geometry import fundamental as jfm, se3 as jse3
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.geometry import cameras, extra, fundamental
from gtsam_personal_tpu_torch.geometry import se3, so3
from gtsam_personal_tpu_torch.tools.factor_samples import _Draw

N = 16
RTOL = 1e-12


def close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def both(jfn, tfn, *args, rtol=RTOL):
    """jax.vmap(jfn) and tfn on the same numpy arguments; returns the
    port's result."""
    ref = jax.vmap(jfn)(*[jnp.asarray(a) for a in args])
    got = tfn(*[torch.tensor(a) for a in args])
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            close(g, r, rtol)
    else:
        close(got, ref, rtol)
    return got


def D(seed=0):
    return _Draw(N, seed)


# -- calibrations --------------------------------------------------------------

CALS = {"cal3_s2": lambda d: d.cal_s2(), "cal3bundler": lambda d: np.stack(
            [d.uniform(300, 600), d.normal(scale=1e-2),
             d.normal(scale=1e-3)], 1),
        "cal3ds2": lambda d: d.cal_ds2(),
        "cal3fisheye": lambda d: np.concatenate(
            [d.cal_s2(), d.normal(4, scale=1e-2)], 1),
        "cal3unified": lambda d: np.concatenate(
            [d.cal_ds2(), d.uniform(0.5, 1.0, 1)], 1)}


@pytest.mark.parametrize("model", sorted(CALS))
def test_uncalibrate_and_project(model):
    d = D(1)
    k, p = CALS[model](d), d.normal(2, scale=0.3)
    p[0] = 0.0          # the fisheye model's guard at the centre
    both(jcam.UNCALIBRATE[model], cameras.UNCALIBRATE[model], k, p)
    pose = d.pose3()
    point = d.seen_point(pose)
    both(lambda a, b, c: jcam.project_point(a, b, c, model),
         lambda a, b, c: cameras.project_point(a, b, c, model), pose, point,
         k)
    assert cameras.CAL_DIMS == jcam.CAL_DIMS


def test_unified_inverse_and_stereo():
    d = D(2)
    k = CALS["cal3unified"](d)
    both(jcam.nplane_to_space_cal3unified, cameras.nplane_to_space_cal3unified,
         k, d.normal(2, scale=0.3))
    ks = np.concatenate([d.cal_s2(), d.uniform(0.05, 0.2, 1)], 1)
    pc = np.concatenate([d.normal(2), d.uniform(2, 6, 1)], 1)
    pc[:2, 2] = [3e-9, -3e-9]       # inside the depth guard
    both(jcam.stereo_project, cameras.stereo_project, ks, pc)


# -- Unit3 ---------------------------------------------------------------------

def _unit3_cases(d):
    n = d.unit()
    n[0] = [0.95, 0.1, np.sqrt(1 - 0.95 ** 2 - 0.01)]   # other basis axis
    return n


def test_unit3_basis_retract_local():
    d = D(3)
    n = _unit3_cases(d)
    both(jex.unit3_basis, extra.unit3_basis, n)
    xi = d.normal(2, scale=0.3)
    xi[1] = 0.0                       # a zero tangent
    xi[2] = [6e-7, 6e-7]              # just below the 1e-12 guard on theta^2
    m = both(jex.unit3_retract, extra.unit3_retract, n, xi).numpy()
    both(jex.unit3_local, extra.unit3_local, n, m)
    m[3] = n[3]                       # coincidence: perp = 0, c = 1
    m[4] = -n[4]                      # the antipode: c = -1
    both(jex.unit3_local, extra.unit3_local, n, m)


def _jac_at_zero(jm, tm, x, dim):
    """d local(x, retract(x, xi)) / d xi at xi = 0, the coincidence of the
    chart, in both packages (a prior factor whose prior equals the value;
    tests/test_torch_factors_breadth.py has the priors away from it)."""
    def jf(p):
        return jax.jacfwd(lambda t: jm.local(p, jm.retract(p, t)))(
            jnp.zeros(dim, dtype=jnp.float64))

    def tf(p):
        return torch.func.jacfwd(lambda t: tm.local(p, tm.retract(p, t)))(
            p.new_zeros(dim))
    # one compiled program: JAX's op-by-op dispatch of a vmapped jacfwd
    # costs several seconds a manifold on the CPU
    ref = jax.jit(jax.vmap(jf))(jnp.asarray(x))
    got = torch.func.vmap(tf)(torch.tensor(x))
    close(got, ref)


# -- every manifold: round trip, and the chart's Jacobian at zero ---------------

MANIFOLDS = ["unit3", "sim3", "essential", "oriented_plane3", "line3", "sim2",
             "fundamental", "simple_fundamental"]


@pytest.mark.parametrize("name", MANIFOLDS)
def test_manifold_retract_local(name):
    d = D(4)
    m, jm = manifolds.get(name), jman.get(name)
    assert (m.dim, m.param_shape) == (jm.dim, jm.param_shape)
    x = d.element(name)
    xi = d.normal(m.dim, scale=0.2)
    y = both(jm.retract, m.retract, x, xi).numpy()
    back = both(jm.local, m.local, x, y)
    close(back, xi, 1e-9)              # the chart round trip
    _jac_at_zero(jm, m, x, m.dim)      # coincidence: zero tangent
    ident = m.identity(device="cpu", dtype=torch.float64)
    close(ident, jm.identity(jnp.float64))


# -- Sim(3), Sim(2): the guards of their series ----------------------------------

def test_sim3_functions():
    d = D(5)
    a, b = d.element("sim3"), d.element("sim3")
    both(jex.sim3_compose, extra.sim3_compose, a, b)
    both(jex.sim3_inverse, extra.sim3_inverse, a)
    both(jex.sim3_transform, extra.sim3_transform, a, d.normal(3))
    xi = d.normal(7, scale=0.3)
    xi[0, 6] = 5e-9                   # just below |lambda| = 1e-8
    xi[1, 6] = 0.0
    g = both(jex.sim3_expmap, extra.sim3_expmap, xi).numpy()
    both(jex.sim3_logmap, extra.sim3_logmap, g)


def test_sim2_functions():
    d = D(6)
    a, b = d.element("sim2"), d.element("sim2")
    both(jex.sim2_compose, extra.sim2_compose, a, b)
    both(jex.sim2_inverse, extra.sim2_inverse, a)
    both(jex.sim2_transform, extra.sim2_transform, a, d.normal(2))
    xi = d.normal(4, scale=0.5)
    xi[0, 2:] = [6e-5, 7e-5]          # |z| just below 1e-4
    xi[1, 2:] = [0.0, 0.0]
    xi[2, 2:] = [0.0, 0.3]            # scale only
    g = both(jex.sim2_expmap, extra.sim2_expmap, xi).numpy()
    both(jex.sim2_logmap, extra.sim2_logmap, g)
    src = d.normal(2)
    dst = np.asarray(extra.sim2_transform(torch.tensor(a[0]),
                                          torch.tensor(src)))
    got = extra.sim2_align_pairs(torch.tensor(src), torch.tensor(dst))
    close(got, jex.sim2_align_pairs(jnp.asarray(src), jnp.asarray(dst)))
    close(got, a[0], 1e-9)


# -- essential matrix, planes, lines, spherical camera ----------------------------

def test_essential_plane_line_spherical():
    d = D(7)
    e = d.element("essential")
    both(jex.essential_matrix, extra.essential_matrix, e)
    both(jex.essential_epipolar_error, extra.essential_epipolar_error, e,
         d.normal(2), d.normal(2))
    plane, pose = d.plane(), d.pose3()
    both(jex.plane_transform, extra.plane_transform, plane, pose)
    line = d.element("line3")
    both(jex.line3_point, extra.line3_point, line, d.normal())
    point = d.seen_point(pose)
    pred = both(jex.spherical_project, extra.spherical_project, pose,
                point).numpy()
    pred[0] = -pred[0]
    both(jex.spherical_reprojection_error,
         extra.spherical_reprojection_error, pose, point, d.unit(pred))


# -- fundamental matrices and transfer --------------------------------------------

def _same_sign(F_, ref):
    """F_ [N, 3, 3] with each matrix's sign set to agree with ref: a
    fundamental matrix is defined up to scale, and the unit singular value
    fixes only its magnitude."""
    F_ = F_.numpy()
    sign = np.sign((F_ * np.asarray(ref)).sum((1, 2)))
    return F_ * sign[:, None, None]


def test_fundamental_functions():
    d = D(8)
    f = d.element("fundamental")
    Fm = both(jfm.fundamental_matrix, fundamental.fundamental_matrix,
              f).numpy()
    # the SVD's signs are LAPACK's choice: compare the matrix it rebuilds
    mine = fundamental.fundamental_matrix(
        fundamental.fundamental_from_matrix(torch.tensor(Fm)))
    ref = jax.vmap(lambda F_: jfm.fundamental_matrix(
        jfm.fundamental_from_matrix(F_)))(jnp.asarray(Fm))
    close(_same_sign(mine, Fm), Fm, 1e-10)
    close(_same_sign(mine, ref), ref, 1e-10)
    Ka, Kb, e = d.K3(), d.K3(), d.element("essential")
    mine = fundamental.fundamental_matrix(fundamental.fundamental_from_essential(
        torch.tensor(Ka), torch.tensor(e), torch.tensor(Kb)))
    ref = jax.vmap(lambda a, b, c: jfm.fundamental_matrix(
        jfm.fundamental_from_essential(a, b, c)))(
            jnp.asarray(Ka), jnp.asarray(e), jnp.asarray(Kb))
    close(_same_sign(mine, ref), ref, 1e-10)
    sf = d.element("simple_fundamental")
    both(jfm.simple_fundamental_matrix, fundamental.simple_fundamental_matrix,
         sf)
    F1, F2, pa, pb = (d.normal(3, 3), d.normal(3, 3), d.pixels(),
                      d.pixels())
    both(jfm.epipolar_transfer, fundamental.epipolar_transfer, F1, pa, F2, pb)
    for fn in ("transfer_to_a", "transfer_to_b", "transfer_to_c"):
        both(getattr(jfm, fn), getattr(fundamental, fn), F1, F2, pa, pb)


def test_so3_normalize_and_se3_additions():
    d = D(9)
    R = d.rot() + d.normal(3, 3, scale=0.05)
    R[0] = -R[0]                      # a reflection: det(U V^T) = -1
    from gtsam_personal_tpu.geometry import so3 as jso3
    got = both(jso3.normalize, so3.normalize, R, rtol=1e-10)
    close(torch.linalg.det(got), np.ones(N), 1e-12)
    pose, pt = d.pose3(), d.normal(3)
    both(jse3.transform_from, se3.transform_from, pose, pt)
    both(jse3.adjoint, se3.adjoint, pose)
    both(jse3.range_to, se3.range_to, pose, pt)
