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
"""

import torch

from gtsam_personal_tpu_torch.ops import _build
from gtsam_personal_tpu_torch.sfm import ba_kernels as bk


def landmark_block_solve_ref(Hpp, t, lam):
    """Plain torch version: the inverse in closed form, then the product."""
    return bk.sym33_matvec_T(bk.sym33_inv_T(
        bk.add_scaled_identity_33_T(Hpp, lam)), t)


def _check(Hpp, t, lam):
    if not all(isinstance(x, torch.Tensor) for x in (Hpp, t, lam)):
        raise TypeError("Hpp, t and lam must be tensors")
    if Hpp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype {Hpp.dtype} not supported (float32, float64)")
    if t.dtype != Hpp.dtype or lam.dtype != Hpp.dtype:
        raise TypeError(f"dtypes differ: Hpp {Hpp.dtype}, t {t.dtype}, "
                        f"lam {lam.dtype}")
    if t.device != Hpp.device or lam.device != Hpp.device:
        raise ValueError(f"devices differ: Hpp {Hpp.device}, t {t.device}, "
                         f"lam {lam.device}")
    if Hpp.dim() != 2 or Hpp.shape[0] != 9 or tuple(t.shape) != (
            3, Hpp.shape[1]) or lam.numel() != 1:
        raise ValueError(f"shapes: Hpp {tuple(Hpp.shape)} must be [9, P], "
                         f"t {tuple(t.shape)} [3, P], lam one element "
                         f"(has {lam.numel()})")
    if not (Hpp.is_contiguous() and t.is_contiguous()):
        raise ValueError("Hpp and t must be contiguous")


def landmark_block_solve(Hpp, t, lam):
    """u [3, P] = (Hpp + lam I)^{-1} t.

    Hpp [9, P] flat-transposed symmetric blocks (entries 0,1,2,4,5,8 read),
    t [3, P], lam a one-element tensor on the same device; float32 or
    float64, contiguous. Counts each kernel launch in
    `landmark_block_solve.launches`."""
    _check(Hpp, t, lam)
    if Hpp.device.type == "cpu":
        return landmark_block_solve_ref(Hpp, t, lam)
    if Hpp.device.type != "cuda":
        raise ValueError(f"no kernel for device {Hpp.device}")
    lib = _build.load()
    fn = (lib.landmark_block_solve_f32 if Hpp.dtype == torch.float32
          else lib.landmark_block_solve_f64)
    u = torch.empty_like(t)
    with torch.cuda.device(Hpp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(Hpp.data_ptr(), t.data_ptr(), lam.data_ptr(), u.data_ptr(),
                Hpp.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"landmark_block_solve kernel launch failed: "
                           f"cudaError {rc}")
    landmark_block_solve.launches += 1
    return u


landmark_block_solve.launches = 0
