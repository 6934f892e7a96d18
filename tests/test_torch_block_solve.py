"""The landmark block solve: its plain torch version against the Pallas
kernel (run in interpret mode, as tests/test_pallas_ops.py runs it), the
wrapper's checks and dispatch, the build plumbing, and its three call sites
in the BA engine. The CUDA kernel itself runs only on a card; chip_smoke.py
holds it against the plain version there.

The camera block solve (the BA engine's block-Jacobi preconditioner): the
wrapper's CPU path against `torch.cholesky_solve`, its checks, the kernel's
arithmetic compiled for the host, and its call sites in the engine. On the
card `tools/time_kernels.py --kernels camera` holds the kernel against
`torch.cholesky_solve`."""

import ctypes
import os
import shutil
import stat
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.ops import pallas_kernels as pk
from gtsam_personal_tpu_torch.ops import _build
from gtsam_personal_tpu_torch.ops.block_solve import (
    camera_block_solve, camera_block_solve_ref, landmark_block_solve,
    landmark_block_solve_ref)
from gtsam_personal_tpu_torch.sfm import ba, ba_kernels as bk, ba_pack
from gtsam_personal_tpu_torch.sfm import synthetic


def _blocks(P, rows, shift, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(P, rows, 3))
    H = np.einsum("pij,pik->pjk", A, A) + shift * np.eye(3)
    return np.ascontiguousarray(H.reshape(P, 9).T), rng.normal(size=(3, P))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_ref_matches_pallas_p1000():
    H, t = _blocks(1000, 2, 0.1, 0)
    ref = pk.landmark_block_solve(jnp.asarray(H), jnp.asarray(t),
                                  jnp.asarray(1e-3), block=256,
                                  interpret=True)
    got = landmark_block_solve_ref(_t(H), _t(t), _t(1e-3))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


def test_ref_matches_pallas_p77_lam0():
    """P = 77 is not a multiple of the Pallas block (padding path)."""
    H, t = _blocks(77, 3, 1.0, 1)
    ref = pk.landmark_block_solve(jnp.asarray(H), jnp.asarray(t),
                                  jnp.asarray(0.0), block=64, interpret=True)
    got = landmark_block_solve_ref(_t(H), _t(t), _t(0.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-8)


def test_ref_matches_jnp_singular_clamp():
    """A singular block takes the |det| < 1e-30 -> +1e-30 clamp in both."""
    H, t = _blocks(5, 2, 0.0, 2)
    H[:, 0] = 0.0
    ref = pk.landmark_block_solve_jnp(jnp.asarray(H), jnp.asarray(t),
                                      jnp.asarray(0.0))
    got = landmark_block_solve_ref(_t(H), _t(t), _t(0.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    H, t = _blocks(33, 2, 0.1, 3)
    args = [torch.as_tensor(x, dtype=dtype) for x in (H, t, 1e-3)]
    before = landmark_block_solve.launches
    u = landmark_block_solve(*args)
    assert landmark_block_solve.launches == before   # no kernel launched
    assert u.dtype == dtype and u.shape == (3, 33)
    assert torch.equal(u, landmark_block_solve_ref(*args))


def _bad_inputs():
    H = torch.eye(3, dtype=torch.float64).reshape(9, 1).repeat(1, 4)
    t = torch.ones(3, 4, dtype=torch.float64)
    lam = torch.tensor(0.0, dtype=torch.float64)
    return {
        "dtype_mismatch": ((H, t.float(), lam), TypeError),
        "int_dtype": ((H.long(), t.long(), lam.long()), TypeError),
        "not_a_tensor": ((H, t, 0.0), TypeError),
        "shape_H": ((H[:8], t, lam), ValueError),
        "shape_t": ((H, t[:, :3], lam), ValueError),
        "lam_numel": ((H, t, torch.zeros(2, dtype=torch.float64)),
                      ValueError),
        "non_contiguous": ((H.T.contiguous().T, t, lam), ValueError),
        "device_mismatch": ((H, t.to("meta"), lam), ValueError),
        "no_kernel_for_device": ((H.to("meta"), t.to("meta"),
                                  lam.to("meta")), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects(case):
    args, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        landmark_block_solve(*args)


def _fake_nvcc(tmp_path, monkeypatch, script):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build" / "kernels")
    return nvcc


def test_build_raises_with_nvcc_messages(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch,
               'echo "error: no sm_90a here" >&2\nexit 2\n')
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert not list((tmp_path / "build" / "kernels").glob("*.so"))


def test_build_is_keyed_and_cached(tmp_path, monkeypatch):
    """One nvcc per source gets the sm_90a flags and an object path, one more
    links the objects into the keyed library; a second build of the same
    sources runs none of them again."""
    calls = tmp_path / "calls"
    _fake_nvcc(tmp_path, monkeypatch,
               f'echo "$@" >> {calls}\n'
               'while [ "$1" != "-o" ]; do shift; done\n'
               'echo lib > "$2"\necho "ptxas info: Used 20 registers" >&2\n')
    path = _build.build()
    assert path.parent == tmp_path / "build" / "kernels"
    assert path == _build.library_path() and path.read_text() == "lib\n"
    assert "Used 20 registers" in path.with_suffix(".so.log").read_text()
    assert _build.build() == path
    lines = calls.read_text().splitlines()
    assert len(lines) == len(_build.SOURCES) + 1
    assert all("arch=compute_90a,code=sm_90a" in ln and "-fmad=false" in ln
               for ln in lines)
    compiles = sorted(ln for ln in lines if " -c " in ln)
    assert [ln.rsplit(" ", 1)[1] for ln in compiles] == sorted(
        map(str, _build.SOURCES))
    (link,) = [ln for ln in lines if " -c " not in ln]
    assert all(os.path.basename(str(s))[:-3] + ".o" in link
               for s in _build.SOURCES)


def test_engine_solves_landmarks_at_three_sites(monkeypatch):
    """_solve_from_lin (sfm/ba.py, shared by both engines) calls the block
    solve once for the gradient term,
    once per CG iteration and once for the back-substitution, always with
    the undamped blocks and lam + 1e-10."""
    prob = synthetic.make_skewed_problem(num_cameras=12, num_points=60,
                                         mean_track=4.0, max_track=8, seed=4)
    state, obs = ba.state_from_bal(prob, device="cpu", dtype=torch.float64)
    pl = ba_pack.make_pack_layout(obs, prob.num_cameras, prob.num_points)
    lin = ba_pack.linearize_ba_pk(state, obs, pl)
    red = ba_pack._reduce_cache(pl, lin)
    seen = []

    def spy(Hpp, t, lam):
        seen.append((Hpp, float(lam)))
        return landmark_block_solve(Hpp, t, lam)

    monkeypatch.setattr(ba, "landmark_block_solve", spy)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    ba_pack._solve_from_lin(pl, lin, red, lam, cg_maxiter=3)
    assert len(seen) == 3 + 2
    assert all(H is red[0] and lm == 1e-3 + 1e-10 for H, lm in seen)


# --- the camera block solve -------------------------------------------------

def _camera_factors(C, dtype, seed, bad=()):
    """Lower factors [C, 9, 9] from bk.safe_chol_blocks of random SPD
    blocks (the cameras in `bad` get an indefinite block, so they take its
    diagonal fallback) and right-hand sides [9, C]."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(C, 9, 14))
    H = A @ A.transpose(0, 2, 1) / 14 + 0.1 * np.eye(9)
    for c in bad:
        H[c] = -np.eye(9) + 0.01 * rng.normal(size=(9, 9))
    H = torch.as_tensor(H, dtype=dtype)
    Ls = bk.safe_chol_blocks(H, torch.tensor(1e-3, dtype=dtype))
    return Ls.contiguous(), torch.as_tensor(rng.normal(size=(9, C)),
                                            dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_camera_wrapper_on_cpu_is_cholesky_solve(dtype):
    """Bit for bit, a fallback (diagonal) factor among the blocks."""
    Ls, r = _camera_factors(37, dtype, 7, bad=(5,))
    assert torch.equal(Ls[5], torch.diag(torch.diagonal(Ls[5])))
    assert not torch.equal(Ls[4], torch.diag(torch.diagonal(Ls[4])))
    before = camera_block_solve.launches
    z = camera_block_solve(Ls, r)
    assert camera_block_solve.launches == before     # no kernel launched
    assert z.dtype == dtype and z.shape == (9, 37)
    assert torch.equal(z, torch.cholesky_solve(r.T[..., None], Ls)[..., 0].T)
    assert torch.equal(z, camera_block_solve_ref(Ls, r))


def _camera_bad_inputs():
    Ls = torch.eye(9, dtype=torch.float64).repeat(4, 1, 1)
    r = torch.ones(9, 4, dtype=torch.float64)
    return {
        "dtype_mismatch": ((Ls, r.float()), TypeError),
        "int_dtype": ((Ls.long(), r.long()), TypeError),
        "not_a_tensor": ((Ls, r.numpy()), TypeError),
        "shape_Ls": ((Ls[:, :8], r), ValueError),
        "shape_Ls_2d": ((Ls[0], r), ValueError),
        "shape_r": ((Ls, r[:, :3]), ValueError),
        "r_camera_major": ((Ls, r.T.contiguous()), ValueError),
        "non_contiguous_Ls": ((Ls.transpose(1, 2), r), ValueError),
        "non_contiguous_r": ((Ls, r.T.contiguous().T), ValueError),
        "device_mismatch": ((Ls, r.to("meta")), ValueError),
        "no_kernel_for_device": ((Ls.to("meta"), r.to("meta")), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_camera_bad_inputs()))
def test_camera_wrapper_rejects(case):
    args, exc = _camera_bad_inputs()[case]
    with pytest.raises(exc):
        camera_block_solve(*args)


_CAMERA_HARNESS = r"""
#include "camera_block_solve.cu"

template <typename T>
static int host_solve(const void* Ls, const void* r, void* z, int64_t C) {
  for (int64_t i = 0; i < C; ++i)
    cbs::solve_block(static_cast<const T*>(Ls) + i * cbs::kNN,
                     static_cast<const T*>(r) + i, static_cast<T*>(z) + i, C);
  return 0;
}

extern "C" int camera_f32(const void* Ls, const void* r, void* z, int64_t C) {
  return host_solve<float>(Ls, r, z, C);
}
extern "C" int camera_f64(const void* Ls, const void* r, void* z, int64_t C) {
  return host_solve<double>(Ls, r, z, C);
}
"""


@pytest.fixture(scope="module")
def host_camera(tmp_path_factory):
    """csrc/camera_block_solve.cu compiled for the host (the launch code is
    left out without nvcc): the kernel's `solve_block`, camera by camera."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    d = tmp_path_factory.mktemp("host_camera")
    (d / "harness.cpp").write_text(_CAMERA_HARNESS)
    lib = d / "libharness.so"
    src = next(s for s in _build.SOURCES if s.name == "camera_block_solve.cu")
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(src.parent), "-o", str(lib),
                    str(d / "harness.cpp")], check=True, timeout=120)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_arithmetic_camera(host_camera, dtype):
    """The kernel's substitutions against torch.cholesky_solve at C = 77
    (not a multiple of the kernel's 64 cameras a block), a fallback factor
    among them: float64 to 1e-12 of the largest entry, float32 to 1e-5, the
    limits the card's check holds the kernel to."""
    Ls, r = _camera_factors(77, dtype, 8, bad=(0, 70))
    z = torch.empty_like(r)
    fn = host_camera.camera_f64 if dtype == torch.float64 else \
        host_camera.camera_f32
    rc = fn(*(ctypes.c_void_p(x.data_ptr()) for x in (Ls, r, z)),
            ctypes.c_int64(77))
    assert rc == 0
    ref = camera_block_solve_ref(Ls.double(), r.double())
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(z.double().numpy(), ref.numpy(), rtol=0,
                               atol=rtol * ref.abs().max().item())


def test_engine_applies_camera_precond_every_iteration(monkeypatch):
    """_solve_from_lin applies the preconditioner once before the CG loop
    and once per iteration of a masked solve (check_every=None), always to
    the same factors, [C, 9, 9], and a [9, C] vector."""
    prob = synthetic.make_skewed_problem(num_cameras=12, num_points=60,
                                         mean_track=4.0, max_track=8, seed=4)
    state, obs = ba.state_from_bal(prob, device="cpu", dtype=torch.float64)
    pl = ba_pack.make_pack_layout(obs, prob.num_cameras, prob.num_points)
    lin = ba_pack.linearize_ba_pk(state, obs, pl)
    red = ba_pack._reduce_cache(pl, lin)
    seen = []

    def spy(Ls, r):
        seen.append((Ls, tuple(r.shape)))
        return camera_block_solve(Ls, r)

    monkeypatch.setattr(ba, "camera_block_solve", spy)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    cg_maxiter = 5
    ba._solve_from_lin(pl, lin, red, lam, cg_maxiter=cg_maxiter,
                       check_every=None)
    assert len(seen) == 1 + cg_maxiter
    assert all(Ls is seen[0][0] for Ls, _ in seen)
    assert tuple(seen[0][0].shape) == (12, 9, 9)
    assert all(shape == (9, 12) for _, shape in seen)
