"""The landmark block solve: its plain torch version against the Pallas
kernel (run in interpret mode, as tests/test_pallas_ops.py runs it), the
wrapper's checks and dispatch, the build plumbing, and its three call sites
in the BA engine. The CUDA kernel itself runs only on a card; chip_smoke.py
holds it against the plain version there."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.ops import pallas_kernels as pk
from gtsam_personal_tpu_torch.ops import _build
from gtsam_personal_tpu_torch.ops.block_solve import (
    landmark_block_solve, landmark_block_solve_ref)
from gtsam_personal_tpu_torch.sfm import ba, ba_pack, synthetic


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
