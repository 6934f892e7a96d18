"""Small-matrix helpers of the BA hot path on feature-major tensors.

JAX counterpart: gtsam_personal_tpu/sfm/ba_kernels.py:sym33_inv_T,
sym33_matvec_T, add_scaled_identity_33_T, safe_chol_blocks (lines 95-143).

A symmetric 3x3 block per landmark is stored flat and transposed, [9, N]
(row-major 3x3 in the first axis), so every entry is a contiguous [N] row.
"""

import torch


def sym33_inv_T(Hflat):
    """Closed-form inverse of symmetric 3x3 blocks [9, N] (adjugate over
    determinant). |det| < 1e-30 becomes +1e-30: the sign is dropped, as in
    the JAX package."""
    a, b, c = Hflat[0], Hflat[1], Hflat[2]
    d, e = Hflat[4], Hflat[5]
    f = Hflat[8]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = det.masked_fill(det.abs() < 1e-30, 1e-30)
    inv_det = 1.0 / det
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    return torch.stack([A, B, C, B, D, E, C, E, F]) * inv_det


def sym33_matvec_T(Hflat, x):
    """[9, N] (row-major 3x3) times [3, N] -> [3, N]."""
    return torch.stack([
        Hflat[0] * x[0] + Hflat[1] * x[1] + Hflat[2] * x[2],
        Hflat[3] * x[0] + Hflat[4] * x[1] + Hflat[5] * x[2],
        Hflat[6] * x[0] + Hflat[7] * x[1] + Hflat[8] * x[2],
    ])


def add_scaled_identity_33_T(Hflat, lam):
    """H + lam I for [9, N] blocks; lam is a float or a 0-d tensor."""
    out = Hflat.clone()
    out[0::4] += lam                       # rows 0, 4, 8: the diagonal
    return out


def safe_chol_blocks(H, lam, jitter=1e-8):
    """Guarded batched Cholesky of damped preconditioner blocks
    [C, d, d] -> lower factors [C, d, d].

    The Schur block Hcc - Gc is PSD in exact arithmetic but can come out
    slightly indefinite in fp32. A block is bad when `cholesky_ex` reports
    it (info != 0) or its factor is not finite: where JAX's cholesky returns
    NaN, cholesky_ex may leave a finite partial factor. Bad blocks take the
    diagonal factor sqrt(clip(diag) + lam + jitter). `cholesky_ex` neither
    raises nor waits for the device, unlike `torch.linalg.cholesky`."""
    d = H.shape[-1]
    eye = torch.eye(d, dtype=H.dtype, device=H.device)
    Ls, info = torch.linalg.cholesky_ex(H + (lam + jitter) * eye)
    bad = (info != 0) | ~torch.isfinite(Ls).flatten(-2).all(-1)
    diag = (torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=0.0)
            + lam + jitter)
    Ld = torch.sqrt(diag)[..., :, None] * eye
    return torch.where(bad[..., None, None], Ld, Ls)
