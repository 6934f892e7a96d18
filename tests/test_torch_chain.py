"""The chain preconditioner's numerics (gtsam_personal_tpu_torch/ops/chain.py)
and the four landmark residuals against the JAX package, float64 on the CPU.

The JAX side keeps blocks feature-major ([d*d, cap], [d, cap]); reshapes
and `.T` bring them to and from the port's [cap, d, d] and [cap, d] here, in
the test, not in the port.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.nonlinear import isam2 as jisam
from gtsam_personal_tpu.slam import factors as jF
from gtsam_personal_tpu_torch.ops import _build, chain
from gtsam_personal_tpu_torch.slam import factors as F

F64 = torch.float64
CAP, NVAR, LAM = 64, 37, 1e-6


def _spd_chain(d, cap, seed):
    """A block-tridiagonal SPD matrix as (D [cap, d, d], O [cap, d, d]):
    the Hessian of a chain of between-like factors plus a prior on every
    block, which is what the engine harvests."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(cap, d, d))       # factor k: A_k x_k + B_k x_{k+1}
    B = rng.normal(size=(cap, d, d))
    D = 0.5 * np.eye(d) + np.einsum("kij,kil->kjl", A, A)
    D[1:] += np.einsum("kij,kil->kjl", B[:-1], B[:-1])
    O = np.einsum("kij,kil->kjl", A, B)
    return D, O


def _dense(Dm, Om):
    cap, d, _ = Dm.shape
    M = np.zeros((cap * d, cap * d))
    for i in range(cap):
        M[i * d:(i + 1) * d, i * d:(i + 1) * d] = Dm[i]
        if i + 1 < cap:
            M[i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d] = Om[i]
            M[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] = Om[i].T
    return M


@pytest.mark.parametrize("d", [3, 4, 6])
def test_chain_factorize_matches_jax(d):
    """chain_prepare + chain_factorize (plain version) against both JAX
    factorizations: the feature-major one and the matrix one."""
    D, O = _spd_chain(d, CAP, seed=d)
    Dm, Om = chain.chain_prepare(torch.tensor(D), torch.tensor(O), NVAR, LAM)
    Uinv = chain.chain_factorize(Dm, Om)
    fm = lambda a: jnp.asarray(a.reshape(CAP, d * d).T)
    jU, jOm = jax.jit(jisam._chain_factorize)(fm(D), fm(O), NVAR, LAM)
    jUm, jOmm = jax.jit(jisam._chain_factorize_m)(
        jnp.asarray(D), jnp.asarray(O), NVAR, LAM)
    np.testing.assert_allclose(Om.numpy(), np.asarray(jOm), rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(jOm), np.asarray(jOmm))
    np.testing.assert_allclose(Uinv.numpy(), np.asarray(jU), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(Uinv.numpy(), np.asarray(jUm), rtol=1e-10,
                               atol=1e-14)
    # padding: identity blocks past nvar
    np.testing.assert_array_equal(Uinv[NVAR:].numpy(),
                                  np.broadcast_to(np.eye(d),
                                                  (CAP - NVAR, d, d)))


@pytest.mark.parametrize("d", [3, 6])
def test_chain_apply_matches_jax_and_dense_solve(d):
    D, O = _spd_chain(d, CAP, seed=10 + d)
    r = np.random.default_rng(d).normal(size=(CAP, d))
    Dm, Om = chain.chain_prepare(torch.tensor(D), torch.tensor(O), NVAR, LAM)
    Uinv = chain.chain_factorize(Dm, Om)
    x = chain.chain_apply(Uinv, *chain.chain_scan_templates(Uinv, Om),
                          torch.tensor(r))
    jx = jax.jit(jisam._chain_apply)(jnp.asarray(Uinv.numpy()),
                                     jnp.asarray(Om.numpy()),
                                     jnp.asarray(r.T))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx).T, rtol=1e-10,
                               atol=1e-13)
    dense = np.linalg.solve(_dense(Dm.numpy(), Om.numpy()), r.reshape(-1))
    np.testing.assert_allclose(x.numpy().reshape(-1), dense, rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 37, 64])
def test_affine_scan_matches_sequential_loop(n, reverse):
    rng = np.random.default_rng(n)
    d = 3
    M = 0.6 * rng.normal(size=(n, d, d))
    c = rng.normal(size=(n, d))
    z = chain.affine_scan(torch.tensor(M), torch.tensor(c), reverse=reverse)
    want = np.zeros((n, d))
    prev = np.zeros(d)
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        prev = M[i] @ prev + c[i]
        want[i] = prev
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-11, atol=1e-12)
    jz = jisam._affine_scan(jnp.asarray(M), jnp.asarray(c), reverse=reverse)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-10,
                               atol=1e-12)


def test_chain_apply_float32_holds_at_10000_blocks():
    """The scale at which bf16 products sent the TPU's chain to NaN: the
    10000 chained SE(2) blocks of the full-size Manhattan graph at capacity
    16384, harvested as the engine harvests them (every factor's diagonal
    term, the odometry couplings). float32 factorization and apply stay
    within 1e-3 of float64, relative, on the applied gradient. (A chain of
    odometry blocks alone, with one prior, has a condition number of the
    order of N^2 = 1e8, and float32 cannot hold 1e-3 there in any
    arithmetic; the closures' diagonal terms are what the preconditioner
    really factorizes.)"""
    from gtsam_personal_tpu_torch.linear.linearize import linearize
    from gtsam_personal_tpu_torch.nonlinear import isam2
    from gtsam_personal_tpu_torch.slam import manhattan
    cap, nvar = 16384, 10000
    graph, initial, _ = manhattan.make_manhattan(nvar, seed=42, device="cpu",
                                                 dtype=F64)
    lin = linearize(graph, initial)

    def pad(a):
        return torch.cat([a, a.new_zeros((cap - nvar,) + a.shape[1:])])

    D = pad(lin.hessian_block_diagonal()["se2"])
    O = pad(isam2._chain_offdiag(lin, "se2"))
    r = pad(lin.gradient_at_zero()["se2"])
    out = {}
    for dtype in (torch.float32, F64):
        Dm, Om = chain.chain_prepare(D.to(dtype), O.to(dtype), nvar, LAM)
        Uinv = chain.chain_factorize(Dm, Om)
        assert Uinv.dtype == dtype
        out[dtype] = chain.chain_apply(
            Uinv, *chain.chain_scan_templates(Uinv, Om), r.to(dtype)).double()
    assert torch.isfinite(out[torch.float32]).all()
    rel = ((out[torch.float32] - out[F64]).norm() / out[F64].norm()).item()
    assert rel < 1e-3, rel


def _bad_chain_inputs():
    D = torch.eye(3, dtype=F64).repeat(8, 1, 1)
    return {
        "dtype": (D.half(), D.half(), TypeError),
        "dtype_mismatch": (D, D.float(), TypeError),
        "shape": (D, D[:4], ValueError),
        "not_square": (D[:, :2], D[:, :2], ValueError),
        "not_contiguous": (torch.zeros(8, 3, 6, dtype=F64)[:, :, ::2], D,
                           ValueError),
        "device_mismatch": (D, D.to("meta"), ValueError),
        "no_kernel_for_device": (D.to("meta"), D.to("meta"), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_chain_inputs()))
def test_chain_factorize_wrapper_rejects(case):
    Dm, Om, exc = _bad_chain_inputs()[case]
    with pytest.raises(exc):
        chain.chain_factorize(Dm, Om)


def test_chain_factorize_counts_only_kernel_launches():
    """The CPU path takes the plain version and counts no launch."""
    before = chain.chain_factorize.launches
    D, O = _spd_chain(3, 8, seed=0)
    chain.chain_factorize(*chain.chain_prepare(torch.tensor(D),
                                               torch.tensor(O), 8, 0.0))
    assert chain.chain_factorize.launches == before


# --- the kernel's step arithmetic, compiled for the host ---------------------

_HARNESS = r"""
#include "chain_factorize.cu"
template <typename T>
int run(const T* D, const T* O, T* U, int64_t cap, int d) {
  switch (d) {
    case 3: chainf::chain_host<T, 3>(D, O, U, cap); return 0;
    case 4: chainf::chain_host<T, 4>(D, O, U, cap); return 0;
    case 6: chainf::chain_host<T, 6>(D, O, U, cap); return 0;
    case 15: chainf::chain_host<T, 15>(D, O, U, cap); return 0;
  }
  return -1;
}
extern "C" int chain_f32(const float* D, const float* O, float* U,
                         int64_t cap, int d) {
  return run<float>(D, O, U, cap, d);
}
extern "C" int chain_f64(const double* D, const double* O, double* U,
                         int64_t cap, int d) {
  return run<double>(D, O, U, cap, d);
}
"""


@pytest.fixture(scope="module")
def host_chain(tmp_path_factory):
    """csrc/chain_factorize.cu compiled for the host (the launch code is
    left out without nvcc): the kernel's step functions, run by chain_host
    in the kernel's order with the lanes of its warp taken in turn."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp("host_chain")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libharness.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(_build.SOURCES[1].parent), "-o",
                    str(lib), str(d / "harness.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", chain.CHAIN_BLOCK_SIZES)
def test_kernel_arithmetic_chain(host_chain, d, dtype):
    """The kernel's arithmetic against chain_factorize_ref at capacity 64
    with 37 active blocks: float64 to 1e-12 of the largest entry, float32 to
    1e-4 (the two differ in the order of their sums and in the inverse,
    adjugate or sweep against pivoted LU)."""
    D, O = _spd_chain(d, CAP, seed=d)
    Dm, Om = chain.chain_prepare(torch.tensor(D, dtype=dtype),
                                 torch.tensor(O, dtype=dtype), NVAR, LAM)
    U = torch.empty_like(Dm)
    fn = host_chain.chain_f64 if dtype == F64 else host_chain.chain_f32
    rc = fn(*(ctypes.c_void_p(x.data_ptr()) for x in (Dm, Om, U)),
            ctypes.c_int64(CAP), ctypes.c_int(d))
    assert rc == 0
    ref = chain.chain_factorize_ref(Dm, Om)
    rtol = 1e-12 if dtype == F64 else 1e-4
    np.testing.assert_allclose(U.numpy(), ref.numpy(), rtol=0,
                               atol=rtol * ref.abs().max().item())


# --- the landmark residuals -------------------------------------------------

def _residual_cases():
    rng = np.random.default_rng(5)
    pose2 = np.array([0.7, -1.2, 0.4])
    pt2 = np.array([3.0, 1.5])
    R = np.asarray(jax.scipy.linalg.expm(jnp.asarray(
        [[0.0, -0.3, 0.2], [0.3, 0.0, -0.1], [-0.2, 0.1, 0.0]])))
    pose3 = np.concatenate([R, rng.normal(size=(3, 1))], axis=1)
    pt3 = rng.normal(size=3) * 3.0
    return {
        "bearing_range_2d": (("se2", "point2"), (pose2, pt2),
                             {"bearing": np.array(0.3),
                              "range": np.array(2.0)}),
        "range_2d": (("se2", "point2"), (pose2, pt2),
                     {"range": np.array(2.5)}),
        "pose_point_2d": (("se2", "point2"), (pose2, pt2),
                          {"measured": np.array([2.0, 0.5])}),
        "pose_point_3d": (("se3", "point3"), (pose3, pt3),
                          {"measured": rng.normal(size=3)}),
    }


@pytest.mark.parametrize("name", sorted(_residual_cases()))
def test_landmark_residual_and_jacobians_match(name):
    """Residual and local-coordinate Jacobians (jacfwd through the
    retraction) of one factor, port against JAX, to rtol 1e-10."""
    from gtsam_personal_tpu.core import manifolds as jman
    from gtsam_personal_tpu_torch.core import manifolds as tman
    groups, xs, meas = _residual_cases()[name]
    jfn = getattr(jF, name + "_residual")
    tfn = F.residual_by_name(name)
    assert tfn is getattr(F, name + "_residual")

    def jlocal(deltas):
        pts = tuple(jman.get(g).retract(jnp.asarray(x), dl)
                    for g, x, dl in zip(groups, xs, deltas))
        return jfn(pts, {k: jnp.asarray(v) for k, v in meas.items()})

    def tlocal(deltas):
        pts = tuple(tman.get(g).retract(torch.tensor(x), dl)
                    for g, x, dl in zip(groups, xs, deltas))
        return tfn(pts, {k: torch.tensor(v) for k, v in meas.items()})

    jz = tuple(jnp.zeros(jman.get(g).dim) for g in groups)
    tz = tuple(torch.zeros(tman.get(g).dim, dtype=F64) for g in groups)
    np.testing.assert_allclose(tlocal(tz).numpy(), np.asarray(jlocal(jz)),
                               rtol=1e-10, atol=1e-14)
    jJ = jax.jacfwd(jlocal)(jz)
    tJ = torch.func.jacfwd(tlocal)(tz)
    for a, b in zip(tJ, jJ):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)


def test_residual_by_name_names_what_it_knows():
    with pytest.raises(ValueError, match="bearing_range_2d"):
        F.residual_by_name("no_such_factor")
