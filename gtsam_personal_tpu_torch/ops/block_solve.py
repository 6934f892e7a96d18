"""Landmark block solve u = (Hpp + lam I)^{-1} t for P symmetric 3x3 blocks.

JAX counterpart: gtsam_personal_tpu/ops/pallas_kernels.py:
landmark_block_solve (the Pallas kernel `_block_solve_kernel`) and
landmark_block_solve_jnp (its plain version).

`landmark_block_solve` launches the hand-written CUDA kernel
(csrc/landmark_block_solve.cu) for CUDA tensors and raises if it cannot; it
takes the plain torch version only for tensors on the CPU. The BA engine
calls it at the three places where the JAX engine multiplies by the stored
inverse HppInv (sfm/ba_pack.py:586, 594 and 643 of the JAX package): the
landmark gradient term, every Schur matvec of the CG loop, and the landmark
back-substitution. A solve from H (6 unique entries) and t moves no more
bytes than a product with a stored inverse (9 entries), so nothing is lost
by solving afresh each time.

`camera_block_solve` applies the camera-major BA engine's block-Jacobi
preconditioner, z = (L L^T)^{-1} r for the 9x9 Cholesky factors of its
camera blocks (sfm/ba.py:_solve_from_lin, `precond`, once before the PCG
loop and once every iteration), with the hand-written CUDA kernel
csrc/camera_block_solve.cu on the card and `torch.cholesky_solve` on the
CPU. It has no Pallas counterpart: the JAX engine calls
`jax.scipy.linalg.cho_solve` there.
"""

import torch

from gtsam_personal_tpu_torch.ops import _build
from gtsam_personal_tpu_torch.sfm import ba_kernels as bk


def _check(contiguous, **tensors):
    """Checks the two wrappers share: tensors of one dtype (float32 or
    float64) on one device, those named in `contiguous` contiguous."""
    if not all(isinstance(x, torch.Tensor) for x in tensors.values()):
        raise TypeError(f"{', '.join(tensors)} must be tensors")
    first = next(iter(tensors.values()))
    if first.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype {first.dtype} not supported (float32, "
                        f"float64)")
    if any(x.dtype != first.dtype for x in tensors.values()):
        raise TypeError("dtypes differ: " + ", ".join(
            f"{k} {x.dtype}" for k, x in tensors.items()))
    if any(x.device != first.device for x in tensors.values()):
        raise ValueError("devices differ: " + ", ".join(
            f"{k} {x.device}" for k, x in tensors.items()))
    if not all(tensors[k].is_contiguous() for k in contiguous):
        raise ValueError(f"{' and '.join(contiguous)} must be contiguous")


def _on_card(x):
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device, which has neither the kernel nor the plain path."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type == "cuda"


def _launch(wrapper, inputs, out, n):
    """Launches `wrapper`'s kernel (its _f32 or _f64 entry point by out's
    dtype) on the current stream of out's device with the pointers of
    `inputs` and `out`, then `n`; counts it in `wrapper.launches`."""
    name = wrapper.__name__
    fn = getattr(_build.load(), name + (
        "_f32" if out.dtype == torch.float32 else "_f64"))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(x.data_ptr() for x in inputs), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    wrapper.launches += 1
    return out


def landmark_block_solve_ref(Hpp, t, lam):
    """Plain torch version: the inverse in closed form, then the product."""
    return bk.sym33_matvec_T(bk.sym33_inv_T(
        bk.add_scaled_identity_33_T(Hpp, lam)), t)


def landmark_block_solve(Hpp, t, lam):
    """u [3, P] = (Hpp + lam I)^{-1} t.

    Hpp [9, P] flat-transposed symmetric blocks (entries 0,1,2,4,5,8 read),
    t [3, P], lam a one-element tensor on the same device; float32 or
    float64, contiguous. Counts each kernel launch in
    `landmark_block_solve.launches`."""
    _check(("Hpp", "t"), Hpp=Hpp, t=t, lam=lam)
    if Hpp.dim() != 2 or Hpp.shape[0] != 9 or tuple(t.shape) != (
            3, Hpp.shape[1]) or lam.numel() != 1:
        raise ValueError(f"shapes: Hpp {tuple(Hpp.shape)} must be [9, P], "
                         f"t {tuple(t.shape)} [3, P], lam one element "
                         f"(has {lam.numel()})")
    if not _on_card(Hpp):
        return landmark_block_solve_ref(Hpp, t, lam)
    return _launch(landmark_block_solve, (Hpp, t, lam), torch.empty_like(t),
                   Hpp.shape[1])


landmark_block_solve.launches = 0


def camera_block_solve_ref(Ls, r):
    """Plain torch version: `torch.cholesky_solve` of the [C, 9, 1]
    right-hand sides, returned as [9, C]."""
    return torch.cholesky_solve(r.T[..., None], Ls)[..., 0].T


def camera_block_solve(Ls, r):
    """z [9, C] = (L L^T)^{-1} r per camera.

    Ls [C, 9, 9] lower Cholesky factors (the upper triangle is not read),
    r [9, C]; float32 or float64, contiguous, on one device. Counts each
    kernel launch in `camera_block_solve.launches`."""
    _check(("Ls", "r"), Ls=Ls, r=r)
    if Ls.dim() != 3 or tuple(Ls.shape[1:]) != (9, 9) or tuple(
            r.shape) != (9, Ls.shape[0]):
        raise ValueError(f"shapes: Ls {tuple(Ls.shape)} must be [C, 9, 9], "
                         f"r {tuple(r.shape)} [9, C]")
    if not _on_card(Ls):
        return camera_block_solve_ref(Ls, r)
    return _launch(camera_block_solve, (Ls, r), torch.empty_like(r),
                   Ls.shape[0])


camera_block_solve.launches = 0
