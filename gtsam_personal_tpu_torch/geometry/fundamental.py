"""Fundamental matrices and epipolar transfer.

JAX counterpart: gtsam_personal_tpu/geometry/fundamental.py (all of it:
FUNDAMENTAL :90, SIMPLE_FUNDAMENTAL :157, the transfer functions :167-189;
reference: gtsam/geometry/FundamentalMatrix.h). Storage is one fixed-shape
tensor per element, [..., 3, 7]:
- fundamental: [U (3x3) | V (3x3) | (s, 0, 0)], F = U diag(1, s, 0) V^T;
- simple_fundamental: [E (3x4) | (fa, fb, 0) | (ca, 0) | (cb, 0)],
  F = Ka^-T E Kb^-1 with the principal points carried as constants.
The functions take any number of leading batch axes, and one element under
`torch.func.vmap`.
"""

import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.geometry import so3
from gtsam_personal_tpu_torch.geometry.extra import (
    essential_local, essential_make, essential_matrix, essential_retract)


# ---------------------------------------------------------------------------
# FundamentalMatrix (reference: FundamentalMatrix.h)
# ---------------------------------------------------------------------------

def fundamental_make(U, s, V):
    """s of shape [..., 1] (or one that reshapes to it)."""
    s = s.reshape(U.shape[:-2] + (1,))
    col = torch.cat([s, torch.zeros_like(U[..., 0, :2])], dim=-1)
    return torch.cat([U, V, col[..., None]], dim=-1)


def fundamental_U(f):
    return f[..., :3]


def fundamental_V(f):
    return f[..., 3:6]


def fundamental_s(f):
    """[..., 1]."""
    return f[..., 0, 6:7]


def fundamental_matrix(f):
    """F = U diag(1, s, 0) V^T (reference: FundamentalMatrix::matrix)."""
    s = fundamental_s(f)
    d = torch.cat([torch.ones_like(s), s, torch.zeros_like(s)], dim=-1)
    return (fundamental_U(f) * d[..., None, :]) @ \
        fundamental_V(f).transpose(-1, -2)


def fundamental_from_matrix(F):
    """SVD into (U, s, V) with reflections removed (reference:
    FundamentalMatrix(const Matrix3&)); a construction helper. The signs
    of singular vectors are LAPACK's choice: compare
    `fundamental_matrix` of the result, not U and V."""
    U, S, Vh = torch.linalg.svd(F)
    V = Vh.transpose(-1, -2)
    U = torch.where((torch.linalg.det(U) < 0)[..., None, None], -U, U)
    V = torch.where((torch.linalg.det(V) < 0)[..., None, None], -V, V)
    return fundamental_make(U, S[..., 1:2] / S[..., 0:1], V)


def fundamental_from_essential(Ka, e, Kb):
    """F = Ka^-T E Kb^-1 (reference: FundamentalMatrix(Ka, E, Kb))."""
    F = torch.linalg.inv(Ka).transpose(-1, -2) @ essential_matrix(e) @ \
        torch.linalg.inv(Kb)
    return fundamental_from_matrix(F)


def fundamental_retract(f, xi):
    """xi = (u_U[3], ds, u_V[3]) (reference: FundamentalMatrix::retract)."""
    return fundamental_make(so3.retract(fundamental_U(f), xi[..., :3]),
                            fundamental_s(f) + xi[..., 3:4],
                            so3.retract(fundamental_V(f), xi[..., 4:7]))


def fundamental_local(a, b):
    return torch.cat([so3.local(fundamental_U(a), fundamental_U(b)),
                      fundamental_s(b) - fundamental_s(a),
                      so3.local(fundamental_V(a), fundamental_V(b))], dim=-1)


def _fundamental_identity(*, device, dtype):
    eye = torch.eye(3, device=device, dtype=dtype)
    return fundamental_make(eye, torch.ones(1, device=device, dtype=dtype),
                            eye)


FUNDAMENTAL = manifolds.register(manifolds.Manifold(
    "fundamental", 7, (3, 7), fundamental_retract, fundamental_local,
    _fundamental_identity))


# ---------------------------------------------------------------------------
# SimpleFundamentalMatrix (reference: FundamentalMatrix.h:133)
# ---------------------------------------------------------------------------

def simple_fundamental_make(e, fa, fb, ca, cb):
    """fa, fb of shape [...]; ca, cb [..., 2]."""
    z = torch.zeros_like(fa)
    c1 = torch.stack([fa, fb, z], dim=-1)
    c2 = torch.cat([ca, z[..., None]], dim=-1)
    c3 = torch.cat([cb, z[..., None]], dim=-1)
    return torch.cat([e, c1[..., None], c2[..., None], c3[..., None]],
                     dim=-1)


def simple_fundamental_E(f):
    return f[..., :4]


def simple_fundamental_fa(f):
    return f[..., 0, 4]


def simple_fundamental_fb(f):
    return f[..., 1, 4]


def _K(focal, c):
    """[[f, 0, c0], [0, f, c1], [0, 0, 1]] for focal [...], c [..., 2]."""
    z, o = torch.zeros_like(focal), torch.ones_like(focal)
    return torch.stack([torch.stack([focal, z, c[..., 0]], dim=-1),
                        torch.stack([z, focal, c[..., 1]], dim=-1),
                        torch.stack([z, z, o], dim=-1)], dim=-2)


def simple_fundamental_matrix(f):
    """F = Ka^-T E Kb^-1 (reference: SimpleFundamentalMatrix::matrix)."""
    Ka = _K(simple_fundamental_fa(f), f[..., :2, 5])
    Kb = _K(simple_fundamental_fb(f), f[..., :2, 6])
    E = essential_matrix(simple_fundamental_E(f))
    return torch.linalg.inv(Ka).transpose(-1, -2) @ E @ torch.linalg.inv(Kb)


def simple_fundamental_retract(f, xi):
    """xi = (u_E[5], dfa, dfb) (reference:
    SimpleFundamentalMatrix::retract)."""
    e = essential_retract(simple_fundamental_E(f), xi[..., :5])
    return simple_fundamental_make(e, simple_fundamental_fa(f) + xi[..., 5],
                                   simple_fundamental_fb(f) + xi[..., 6],
                                   f[..., :2, 5], f[..., :2, 6])


def simple_fundamental_local(a, b):
    return torch.cat([
        essential_local(simple_fundamental_E(a), simple_fundamental_E(b)),
        torch.stack([simple_fundamental_fa(b) - simple_fundamental_fa(a),
                     simple_fundamental_fb(b) - simple_fundamental_fb(a)],
                    dim=-1)], dim=-1)


def _simple_fundamental_identity(*, device, dtype):
    e = essential_make(torch.eye(3, device=device, dtype=dtype),
                       torch.tensor([1.0, 0.0, 0.0], device=device,
                                    dtype=dtype))
    one = torch.ones((), device=device, dtype=dtype)
    zero2 = torch.zeros(2, device=device, dtype=dtype)
    return simple_fundamental_make(e, one, one, zero2, zero2)


SIMPLE_FUNDAMENTAL = manifolds.register(manifolds.Manifold(
    "simple_fundamental", 7, (3, 7), simple_fundamental_retract,
    simple_fundamental_local, _simple_fundamental_identity))


# ---------------------------------------------------------------------------
# Epipolar transfer (reference: FundamentalMatrix.cpp:15, TripleF)
# ---------------------------------------------------------------------------

def _line(F, p):
    """F [..., 3, 3] applied to the homogeneous point of p [..., 2]."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return (F @ ph[..., None])[..., 0]


def epipolar_transfer(Fca, pa, Fcb, pb):
    """The point [..., 2] in view c where the epipolar lines of pa (through
    Fca) and pb (through Fcb) meet."""
    x = torch.linalg.cross(_line(Fca, pa), _line(Fcb, pb), dim=-1)
    w = x[..., 2:3]
    return x[..., :2] / torch.where(w.abs() < 1e-12, torch.ones_like(w), w)


def transfer_to_a(Fab, Fca, pb, pc):
    """TripleF::transferToA: the lines from b (Fab) and c (Fca^T)."""
    return epipolar_transfer(Fab, pb, Fca.transpose(-1, -2), pc)


def transfer_to_b(Fab, Fbc, pa, pc):
    return epipolar_transfer(Fab.transpose(-1, -2), pa, Fbc, pc)


def transfer_to_c(Fca, Fbc, pa, pb):
    return epipolar_transfer(Fca, pa, Fbc.transpose(-1, -2), pb)
