"""The port's navigation package (gtsam_personal_tpu_torch/navigation/)
against the JAX package's, float64 on the CPU, from the same numpy inputs.

Tolerance: rtol 1e-10 with an atol of 1e-10 times the largest entry of the
array compared (two evaluation orders of an entry that cancels to ~1e-16
agree in no relative digit). Every JAX function here sees one shape, so it
compiles once. The residuals of navigation/factors.py and dynamics.py, with
their Jacobians, are held to the JAX package's in
tests/test_torch_factors_breadth.py (they are in slam/factors.py's
residual_names); this file checks that they are there, and the builder
sugar that makes their measurements and noise.

The CUDA kernels of ops/preintegration.py run only on a card; their
arithmetic is plain C++ outside the launch, so `test_kernel_arithmetic_*`
compiles the sources with the host's C++ compiler and holds that against
the plain versions.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core.graph import GraphBuilder as JGraphBuilder
from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.navigation import factors as jnav
from gtsam_personal_tpu.navigation import geodetic as jgeo
from gtsam_personal_tpu.navigation import navstate as jns
from gtsam_personal_tpu.navigation import preintegration as jpre
from gtsam_personal_tpu.navigation import scenario as jscen
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.navigation import factors as nav
from gtsam_personal_tpu_torch.navigation import geodetic as geo
from gtsam_personal_tpu_torch.navigation import navstate as ns
from gtsam_personal_tpu_torch.navigation import preintegration as pre
from gtsam_personal_tpu_torch.navigation import scenario as scen
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.ops import _build
from gtsam_personal_tpu_torch.ops import preintegration as ops
from gtsam_personal_tpu_torch.slam import factors as F

RTOL = 1e-10
N = 20          # samples of every segment given to a JAX function
DT = 0.01


def close(got, ref, what="", rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def segment(case, seed=0, n=N):
    """(accs, gyros, dts, bias) of one segment: 'generic' turns at about
    0.5 rad/s; 'slow' at 1e-5 rad/s, so its angle stays in the Taylor branch
    of Exp and Jl^{-1} throughout. Every segment starts at theta = 0."""
    rng = np.random.default_rng(seed)
    accs = rng.normal(size=(n, 3)) + np.array([0.0, 0.0, 9.81])
    rate = 0.5 if case == "generic" else 1e-5
    gyros = rate * rng.normal(size=(n, 3))
    bias = 0.01 * rng.normal(size=6)
    bias[3:] *= rate / 0.5
    return accs, gyros, np.full(n, DT), bias


def jparams():
    return jpre.PreintegrationParams.make_shared_u()


def pim_close(tp, jp, fields):
    for k in fields:
        close(getattr(tp, k).numpy(), getattr(jp, k), k)


# -- navstate ------------------------------------------------------------------

def _states(rng, n):
    from gtsam_personal_tpu_torch.geometry import so3
    R = so3.expmap(t(rng.normal(size=(n, 3)))).numpy()
    return np.concatenate([R, rng.normal(size=(n, 3, 2))], axis=2)


def test_navstate_matches_jax():
    rng = np.random.default_rng(1)
    x, y = _states(rng, 6), _states(rng, 6)
    xi = 0.3 * rng.normal(size=(6, 9))
    close(ns.retract(t(x), t(xi)).numpy(),
          jax.vmap(jns.retract)(jnp.asarray(x), jnp.asarray(xi)), "retract")
    close(ns.local(t(x), t(y)).numpy(),
          jax.vmap(jns.local)(jnp.asarray(x), jnp.asarray(y)), "local")
    pose, vel = x[:, :, :4], x[:, :, 4]
    assert np.array_equal(ns.from_pose_vel(t(pose), t(vel)).numpy(), x)
    assert np.array_equal(ns.pose_of(t(x)).numpy(), pose)
    assert np.array_equal(ns.make(t(x[:, :, :3]), t(x[:, :, 3]),
                                  t(vel)).numpy(), x)
    assert np.array_equal(ns.rotation(t(x)).numpy(), x[:, :, :3])
    assert np.array_equal(ns.position(t(x)).numpy(), x[:, :, 3])
    assert np.array_equal(ns.velocity(t(x)).numpy(), vel)
    assert np.array_equal(ns.identity(device="cpu", dtype=torch.float64),
                          np.asarray(jns.identity(jnp.float64)))
    close(ns.local(t(x), ns.retract(t(x), t(xi))).numpy(), xi, "round trip",
          rtol=1e-9)


# -- preintegration --------------------------------------------------------------

@pytest.mark.parametrize("case", ["generic", "slow"])
def test_integrate_matches_jax(case):
    accs, gyros, dts, bias = segment(case)
    jp = jpre.integrate(jparams(), *map(jnp.asarray, (bias, accs, gyros,
                                                       dts)))
    tp = pre.integrate(pre.params_from_numpy(jparams(), device="cpu"),
                       *map(t, (bias, accs, gyros, dts)))
    pim_close(tp, jp, pre.PIM._fields)
    if case == "slow":
        assert float((tp.zeta[:3] ** 2).sum()) < 1e-6


@pytest.mark.parametrize("case", ["generic", "slow"])
def test_integrate_manifold_matches_jax(case):
    accs, gyros, dts, bias = segment(case, seed=2)
    jp = jpre.integrate_manifold(jparams(), *map(jnp.asarray,
                                                 (bias, accs, gyros, dts)))
    tp = pre.integrate_manifold(
        pre.params_from_numpy(jparams(), device="cpu"),
        *map(t, (bias, accs, gyros, dts)))
    pim_close(tp, jp, pre.PIM._fields)


@pytest.mark.parametrize("case", ["generic", "slow"])
def test_integrate_ahrs_matches_jax(case):
    _, gyros, dts, bias = segment(case, seed=3)
    cov = 1e-6 * np.eye(3)
    jp = jpre.integrate_ahrs(jnp.asarray(cov), jnp.asarray(bias[3:]),
                             jnp.asarray(gyros), jnp.asarray(dts))
    tp = pre.integrate_ahrs(t(cov), t(bias[3:]), t(gyros), t(dts))
    pim_close(tp, jp, pre.AhrsPIM._fields)


def test_predict_and_compute_error_match_jax():
    accs, gyros, dts, bias = segment("generic", seed=4)
    rng = np.random.default_rng(4)
    xi, xj = _states(rng, 1)[0], _states(rng, 1)[0]
    bias2 = bias + 0.01 * rng.normal(size=6)
    jp = jpre.integrate(jparams(), *map(jnp.asarray, (bias, accs, gyros,
                                                       dts)))
    tparams = pre.params_from_numpy(jparams(), device="cpu")
    tp = pre.pim_from_numpy(jp, device="cpu")
    close(pre.predict(tp, tparams, t(xi), t(bias2)).numpy(),
          jpre.predict(jp, jparams(), jnp.asarray(xi), jnp.asarray(bias2)),
          "predict")
    close(pre.compute_error(tp, tparams, t(xi), t(xj), t(bias2)).numpy(),
          jpre.compute_error(jp, jparams(), jnp.asarray(xi), jnp.asarray(xj),
                             jnp.asarray(bias2)), "compute_error")
    close(pre.bias_corrected_delta(tp, t(bias2)).numpy(),
          jpre.bias_corrected_delta(jp, jnp.asarray(bias2)), "bias corrected")


def test_ahrs_residual_matches_jax():
    _, gyros, dts, bias = segment("generic", seed=5)
    rng = np.random.default_rng(5)
    jp = jpre.integrate_ahrs(jnp.eye(3) * 1e-6, jnp.asarray(bias[3:]),
                             jnp.asarray(gyros), jnp.asarray(dts))
    meas = {k: np.asarray(getattr(jp, k)) for k in ("theta", "H_bw",
                                                    "bias_hat")}
    from gtsam_personal_tpu_torch.geometry import so3
    Ri, Rj = so3.expmap(t(rng.normal(size=(2, 3)))).numpy()
    b = bias[3:] + 0.01 * rng.normal(size=3)
    close(pre.ahrs_residual((t(Ri), t(Rj), t(b)),
                            {k: t(v) for k, v in meas.items()}).numpy(),
          jpre.ahrs_residual(tuple(map(jnp.asarray, (Ri, Rj, b))),
                             {k: jnp.asarray(v) for k, v in meas.items()}))


def _ragged(seed):
    """Three segments of 1, 17 and N samples, and their padded batch."""
    rng = np.random.default_rng(seed)
    segs = [np.concatenate([rng.normal(size=(n, 3)) + [0, 0, 9.81],
                            0.5 * rng.normal(size=(n, 3))], 1)
            for n in (1, 17, N)]
    bias = 0.01 * rng.normal(size=(3, 6))
    return segs, bias, pre.pad_segments(segs, DT, device="cpu",
                                        dtype=torch.float64)


def test_padded_batch_equals_segments_bitwise():
    """A sample of dt = 0 is the identity: the padded batch gives each
    segment exactly what it gives alone, in every backend."""
    segs, bias, (accs, gyros, dts) = _ragged(6)
    assert dts.shape == (3, N) and float(dts[0, 1:].abs().sum()) == 0.0
    params = pre.params_from_numpy(jparams(), device="cpu")
    batch = pre.integrate_batch(params, t(bias), accs, gyros, dts)
    manif = pre.integrate_manifold_batch(params, t(bias), accs, gyros, dts)
    ahrs = pre.integrate_ahrs_batch(params.gyro_cov, t(bias[:, 3:]), gyros,
                                    dts)
    for k, s in enumerate(segs):
        one = (t(s[:, :3]), t(s[:, 3:]), torch.full((len(s),), DT,
                                                    dtype=torch.float64))
        for got, ref in ((batch, pre.integrate(params, t(bias[k]), *one)),
                         (manif, pre.integrate_manifold(params, t(bias[k]),
                                                        *one))):
            for f in ("zeta", "H_ba", "H_bw", "cov", "bias_hat"):
                assert torch.equal(getattr(got, f)[k], getattr(ref, f)), f
        ref = pre.integrate_ahrs(params.gyro_cov, t(bias[k, 3:]), one[1],
                                 one[2])
        for f in ("theta", "H_bw", "cov"):
            assert torch.equal(getattr(ahrs, f)[k], getattr(ref, f)), f


def test_numpy_round_trips():
    accs, gyros, dts, bias = segment("generic")
    jp = jpre.integrate(jparams(), *map(jnp.asarray, (bias, accs, gyros,
                                                       dts)))
    tp = pre.pim_from_numpy(jp, device="cpu")
    back = pre.pim_to_numpy(tp)
    for k in pre.PIM._fields:
        assert np.array_equal(back[k], np.asarray(getattr(jp, k)))
    tparams = pre.params_from_numpy(jparams(), device="cpu")
    for k in pre.PreintegrationParams._fields:
        assert np.array_equal(getattr(tparams, k).numpy(),
                              np.asarray(getattr(jparams(), k)))
    mine = pre.PreintegrationParams.make_shared_u(device="cpu")
    for k in pre.PreintegrationParams._fields:
        assert np.array_equal(getattr(mine, k).numpy(),
                              np.asarray(getattr(jparams(), k)))
    assert pre.params_from_numpy({"gravity": np.zeros(3)},
                                 device="cpu").accel_cov is None


def test_params_default_to_the_card():
    """Without a device the constructors take the card, and raise where
    there is none."""
    from gtsam_personal_tpu_torch.tools import imu_gps_vio
    makers = (pre.PreintegrationParams.make_shared_u,
              lambda: pre.params_from_numpy(jparams()),
              lambda: pre.pim_from_numpy({k: np.zeros(3)
                                          for k in pre.PIM._fields}),
              imu_gps_vio.imu_params)
    for make in makers:
        if torch.cuda.is_available():
            assert make()[0].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                make()


def test_wrappers_check_their_inputs():
    accs, gyros, dts = (torch.zeros(2, 5, 3), torch.zeros(2, 5, 3),
                        torch.zeros(2, 5))
    covs = torch.zeros(3, 3, 3)
    with pytest.raises(ValueError, match="shape"):
        ops.preint_tangent(accs, gyros, dts, torch.zeros(2, 3), covs)
    with pytest.raises(ValueError, match="dtype or device"):
        ops.preint_tangent(accs, gyros, dts.double(), torch.zeros(2, 6), covs)
    with pytest.raises(TypeError, match="not supported"):
        ops.preint_tangent(accs.half(), gyros.half(), dts.half(),
                           torch.zeros(2, 6).half(), covs.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.preint_tangent(accs, gyros, dts, torch.zeros(6, 2).T, covs)
    with pytest.raises(ValueError, match="mode"):
        ops.preint_rotation("tangent", gyros, dts, torch.zeros(2, 6))
    with pytest.raises(ValueError, match="shape"):
        ops.preint_rotation("ahrs", gyros, dts, torch.zeros(2, 6),
                            gyro_cov=torch.zeros(3, 3))
    n0 = ops.preint_tangent.launches
    ops.preint_tangent(accs, gyros, dts, torch.zeros(2, 6), covs)
    assert ops.preint_tangent.launches == n0     # the CPU takes no kernel


# -- the kernels' arithmetic, compiled for the host ---------------------------------

_HARNESS = r"""
#include "preint_tangent.cu"
#include "preint_rotation.cu"
template <typename T>
void tangent(const T* a, const T* g, const T* d, const T* b, const T* c,
             T* z, T* H, T* cv, T* dT, int64_t S, int64_t N) {
  for (int64_t s = 0; s < S; ++s) {
    preint::Carry<T> carry;
    preint::tangent_segment<T>(0, 1, a + s * N * 3, g + s * N * 3, d + s * N,
                               N, b + s * 6, c, carry, z + s * 9, H + s * 54,
                               cv + s * 81, dT + s);
  }
}
extern "C" void tangent_f64(const double* a, const double* g,
    const double* d, const double* b, const double* c, double* z, double* H,
    double* cv, double* dT, int64_t S, int64_t N) {
  tangent<double>(a, g, d, b, c, z, H, cv, dT, S, N);
}
extern "C" void rotation_f64(int ahrs, const double* a, const double* g,
    const double* d, const double* b, const double* gc, double* R,
    double* dR, double* p, double* v, double* dp, double* dv, double* cov,
    int64_t S, int64_t N) {
  for (int64_t s = 0; s < S; ++s) {
    if (ahrs)
      preint_rot::rotation_host<double, true>(nullptr, g + s * N * 3,
          d + s * N, N, b + s * 3, gc, R + s * 9, dR + s * 27, nullptr,
          nullptr, nullptr, nullptr, cov + s * 9);
    else
      preint_rot::rotation_host<double, false>(a + s * N * 3, g + s * N * 3,
          d + s * N, N, b + s * 6, gc, R + s * 9, dR + s * 54, p + s * 3,
          v + s * 3, dp + s * 18, dv + s * 18, nullptr);
  }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """csrc/preint_*.cu compiled for the host (the launch code is left out
    without nvcc) into a library with a C entry point per scan."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libharness.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(_build.SOURCES[0].parent), "-o",
                    str(lib), str(d / "harness.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _p(x):
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def test_kernel_arithmetic_tangent(host_kernels):
    segs, bias, (accs, gyros, dts) = _ragged(7)
    covs = pre.params_from_numpy(jparams(), device="cpu").covs(accs)
    bias = t(bias)          # held here: the library reads its memory
    ref = ops.preint_tangent_ref(accs, gyros, dts, bias, covs)
    out = [torch.empty_like(r) for r in ref]
    host_kernels.tangent_f64(*map(_p, (accs, gyros, dts, bias, covs)),
                             *map(_p, out), ctypes.c_int64(3),
                             ctypes.c_int64(N))
    for name, o, r in zip(("zeta", "H", "cov", "dT"), out, ref):
        close(o.numpy(), r.numpy(), name, rtol=1e-12)


# csrc/preint_rotation.cu's round: 32 lanes of 8 samples
ROUND = 256


def _rotation_host(lib, mode, accs, gyros, dts, b, gcov):
    """csrc/preint_rotation.cu's rotation_host on [S, N] samples: the
    kernel's outputs, in the plain version's order."""
    S, n = dts.shape
    nd = 6 if mode == "manifold" else 3
    R, dR = torch.empty(S, 3, 3, dtype=dts.dtype), torch.empty(
        S, nd, 3, 3, dtype=dts.dtype)
    if mode == "manifold":
        p, v, dp, dv = (torch.empty(S, *sh, dtype=dts.dtype)
                        for sh in ((3,), (3,), (6, 3), (6, 3)))
        cov, out = None, (R, p, v, dR, dp, dv)
    else:
        p = v = dp = dv = None
        cov = torch.empty(S, 3, 3, dtype=dts.dtype)
        out = (R, dR, cov)
    lib.rotation_f64(int(mode == "ahrs"),
                     *map(_p, (accs, gyros, dts, b, gcov)),
                     *map(_p, (R, dR, p, v, dp, dv, cov)),
                     ctypes.c_int64(S), ctypes.c_int64(n))
    return out


@pytest.mark.parametrize("mode", ["manifold", "ahrs"])
def test_kernel_arithmetic_rotation(host_kernels, mode):
    """The kernel's grouping on the host against the plain scan: the ragged
    1/17/20 batch and a segment of more than one round (the carry)."""
    segs, bias, _ = _ragged(8)
    rng = np.random.default_rng(18)
    n = ROUND + 44
    segs.append(np.concatenate([rng.normal(size=(n, 3)) + [0, 0, 9.81],
                                0.5 * rng.normal(size=(n, 3))], 1))
    bias = np.concatenate([bias, 0.01 * rng.normal(size=(1, 6))])
    accs, gyros, dts = pre.pad_segments(segs, DT, device="cpu",
                                        dtype=torch.float64)
    gcov = 1e-4 * torch.eye(3, dtype=torch.float64)
    b = t(bias) if mode == "manifold" else t(bias[:, 3:])
    ref = ops.preint_rotation_ref(mode, gyros, dts, b, accs=accs,
                                  gyro_cov=gcov)
    out = _rotation_host(host_kernels, mode, accs, gyros, dts, b, gcov)
    for k, (o, r) in enumerate(zip(out, ref)):
        close(o.numpy(), r.numpy(), f"output {k}", rtol=1e-12)


@pytest.mark.parametrize("mode", ["manifold", "ahrs"])
def test_kernel_order_padded_equals_alone(host_kernels, mode):
    """The kernel's grouping does not depend on N: a segment padded with
    dt = 0 samples, within a round and across rounds, gives bitwise what
    it gives alone."""
    rng = np.random.default_rng(19)
    lengths = (1, 37, ROUND + 44)
    segs = [np.concatenate([rng.normal(size=(n, 3)) + [0, 0, 9.81],
                            0.5 * rng.normal(size=(n, 3))], 1)
            for n in lengths]
    bias = t(0.01 * rng.normal(size=(3, 6)))
    b = bias if mode == "manifold" else bias[:, 3:].contiguous()
    gcov = 1e-4 * torch.eye(3, dtype=torch.float64)
    # padded to the longest (two rounds), then with zeros to three rounds
    accs, gyros, dts = (torch.nn.functional.pad(
        x, (0, 0) * (x.dim() - 2) + (0, 3 * ROUND - x.shape[1]))
        for x in pre.pad_segments(segs, DT, device="cpu",
                                  dtype=torch.float64))
    padded = _rotation_host(host_kernels, mode, accs, gyros, dts, b, gcov)
    for k, n in enumerate(lengths):
        alone = _rotation_host(
            host_kernels, mode, accs[k:k + 1, :n].contiguous(),
            gyros[k:k + 1, :n].contiguous(), dts[k:k + 1, :n].contiguous(),
            b[k:k + 1].contiguous(), gcov)
        for j, (x, y) in enumerate(zip(padded, alone)):
            assert torch.equal(x[k], y[0]), (n, j)


# -- factors ---------------------------------------------------------------------

def test_navigation_residuals_are_named():
    """Every residual of navigation/factors.py and dynamics.py resolves by
    name and is driven by the breadth checks."""
    names = set(F.residual_names())
    for name, fn in nav.NAMED.items():
        assert name in names
        assert F.residual_by_name(name) is fn


def test_builder_sugar_matches_jax():
    """add_imu_factor, add_combined_imu_factor, add_gps_factor and
    add_ahrs_factor: the graph's error at the same values equals the JAX
    package's."""
    accs, gyros, dts, bias = segment("generic", seed=9)
    jpar = jparams()
    jp = jpre.integrate(jpar, *map(jnp.asarray, (bias, accs, gyros, dts)))
    ja = jpre.integrate_ahrs(jnp.eye(3) * 1e-6, jnp.asarray(bias[3:]),
                             jnp.asarray(gyros), jnp.asarray(dts))
    tpar = pre.params_from_numpy(jpar, device="cpu")
    tp = pre.pim_from_numpy(jp, device="cpu")
    ta = pre.AhrsPIM(*(t(np.asarray(getattr(ja, k)))
                       for k in pre.AhrsPIM._fields))
    rng = np.random.default_rng(9)
    x = _states(rng, 3)
    vals = {"se3": x[:, :, :4], "vel3": x[:, :, 4],
            "imu_bias": 0.01 * rng.normal(size=(3, 6)),
            "so3": x[:, :, :3], "gyro_bias": 0.01 * rng.normal(size=(2, 3))}
    jb, tb = JGraphBuilder(), GraphBuilder()
    jnav.add_imu_factor(jb, 0, 1, 0, jp, jpar)
    nav.add_imu_factor(tb, 0, 1, 0, tp, tpar)
    jnav.add_combined_imu_factor(jb, 1, 2, 1, 2, jp, jpar)
    nav.add_combined_imu_factor(tb, 1, 2, 1, 2, tp, tpar)
    for b, mod in ((jb, jnav), (tb, nav)):
        mod.add_gps_factor(b, 2, np.array([1.0, 2.0, 3.0]),
                           F.diag_noise([0.5] * 3))
    jnav.add_ahrs_factor(jb, 0, 1, 0, ja)
    nav.add_ahrs_factor(tb, 0, 1, 0, ta)
    e_j = float(jopt.graph_error(jb.build(dtype=jnp.float64), JValues(
        {k: jnp.asarray(v) for k, v in vals.items()})))
    e_t = float(optimizers.graph_error(
        tb.build(device="cpu", dtype=torch.float64),
        values_from_numpy(vals, device="cpu", dtype=torch.float64)))
    close(e_t, e_j, "graph error")


def test_gauss_markov_discrete_sigmas():
    close(nav.gauss_markov_discrete_sigmas([0.1, 0.2, 0.3], 0.25),
          jnav.gauss_markov_discrete_sigmas([0.1, 0.2, 0.3], 0.25))


# -- scenarios and geodetic ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["constant_twist", "accelerating"])
def test_scenarios_match_jax(kind):
    g = np.array([0.0, 0.0, -9.81])
    if kind == "constant_twist":
        args = (np.array([0.1, -0.2, 0.3]), np.array([1.5, 0.2, -0.1]))
        J, T = jscen.ConstantTwistScenario, scen.ConstantTwistScenario
    else:
        from gtsam_personal_tpu_torch.geometry import so3
        args = (so3.expmap(t([0.2, -0.1, 0.4])).numpy(),
                np.array([1.0, 2.0, 3.0]), np.array([0.5, 0.0, 0.0]),
                np.array([0.1, 0.2, 0.0]), np.array([0.01, 0.02, 0.3]))
        J, T = jscen.AcceleratingScenario, scen.AcceleratingScenario
    j, p = J(*args), T(*args)
    for a, b in zip(p.imu_measurements(0.4, DT, g),
                    j.imu_measurements(0.4, DT, g)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for tm in (0.0, 0.37, 2.5):
        np.testing.assert_allclose(p.nav_state(tm).numpy(),
                                   np.asarray(j.nav_state(tm)), rtol=0,
                                   atol=1e-12)
    times = np.array([0.1, 0.2])
    np.testing.assert_allclose(p.pose(times).numpy(), np.stack(
        [np.asarray(j.pose(x)) for x in times]), rtol=0, atol=1e-12)


def test_geodetic_matches_jax():
    rng = np.random.default_rng(10)
    lat, lon = rng.uniform(-80, 80, 20), rng.uniform(-180, 180, 20)
    h = rng.uniform(-100, 3000, 20)
    origin = (47.3, 8.5, 400.0)
    ecef = geo.lla_to_ecef(lat, lon, h)
    np.testing.assert_allclose(ecef, jgeo.lla_to_ecef(lat, lon, h), rtol=0,
                               atol=1e-12 * np.abs(ecef).max())
    for a, b in zip(geo.ecef_to_lla(ecef), jgeo.ecef_to_lla(ecef)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-9)
    enu = geo.lla_to_enu(lat, lon, h, origin)
    np.testing.assert_allclose(enu, jgeo.lla_to_enu(lat, lon, h, origin),
                               rtol=0, atol=1e-12 * np.abs(enu).max())
    np.testing.assert_allclose(geo.ecef_to_enu(ecef, origin),
                               jgeo.ecef_to_enu(ecef, origin), rtol=0,
                               atol=1e-12 * np.abs(enu).max())
    np.testing.assert_allclose(geo.enu_to_ecef(enu, origin),
                               jgeo.enu_to_ecef(enu, origin), rtol=0,
                               atol=1e-12 * np.abs(ecef).max())
