"""SO(n): rotations in n dimensions, as full n x n matrices.

JAX counterpart: gtsam_personal_tpu/geometry/son.py (all of it; reference:
geometry/SOn.h, SO4.h). `retract` and `local` are the Cayley chart and its
inverse, the reference's default retraction for n > 3 (SOn.h:160
ChartAtOrigin::Retract) and the chart Shonan averaging relies on;
`expmap` and `logmap` are the true exponential and logarithm.

The tangent order is the reference's recursive SOn::Hat (SOn.h:110): the
last 2 x 2 block is xi[-1], and the matrix grows one border at a time with
alternating signs.

`solve_small` is the one p x p solve of this package that `linearize`
differentiates (here and in sfm/shonan.py); see its docstring for why it is
not `torch.linalg.solve`.
"""

from functools import lru_cache

import numpy as np
import torch

from gtsam_personal_tpu_torch.core import manifolds


class _SolveSmall(torch.autograd.Function):
    """X = A^{-1} B with explicit derivative rules."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, B):
        return torch.linalg.solve(A, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _ = inputs
        ctx.save_for_backward(A, output)
        ctx.save_for_forward(A, output)

    @staticmethod
    def jvp(ctx, dA, dB):
        A, X = ctx.saved_tensors
        rhs = torch.zeros_like(X) if dB is None else dB
        if dA is not None:
            rhs = rhs - dA @ X
        return torch.linalg.solve(A, rhs)

    @staticmethod
    def backward(ctx, G):
        A, X = ctx.saved_tensors
        gB = torch.linalg.solve(A.transpose(-1, -2), G)
        return -gB @ X.transpose(-1, -2), gB


def solve_small(A, B):
    """A^{-1} B for small square systems [..., p, p], [..., p, k].

    Every differentiated solve of the Cayley charts goes through this and
    not `torch.linalg.solve`: under `vmap` of `jacfwd` (linearize's form)
    the forward-mode derivative of `torch.linalg.solve` comes out wrong for
    every batch element but the first (torch 2.13, on the CPU; at p = 5 and
    a batch of 4 the Jacobian is off by 36 to 1.4e4 on elements 1-3). This
    function gives the solve its own forward rule, dX = A^{-1}(dB - dA X),
    computed from the primal A alone, and lets torch derive the rule under
    `vmap` from it (`generate_vmap_rule`). geometry/triangulation.py:solve3
    covers the 3 x 3 solves the same way by the adjugate."""
    return _SolveSmall.apply(A, B)


def ambient_dim(d: int) -> int:
    """Matrix size n with d = n(n-1)/2 tangent dims."""
    n = int(round((1 + np.sqrt(1 + 8 * d)) / 2))
    assert n * (n - 1) // 2 == d
    return n


def tangent_dim(n: int) -> int:
    return n * (n - 1) // 2


@lru_cache(maxsize=None)
def _hat_basis(n: int) -> np.ndarray:
    """[d, n, n] basis with hat(xi) = einsum('k,kij->ij', xi, basis), in the
    reference's recursive SOn::Hat order (SOn.cpp:25): the first m-1
    entries fill the last row and column with alternating signs starting
    at (-1)^{m(m-1)/2}; the tail recurses into the top-left block."""
    d = tangent_dim(n)
    basis = np.zeros((d, n, n))

    def fill(m: int, xi_ids):
        if m == 2:
            k = xi_ids[0]
            basis[k, 0, 1] = -1.0
            basis[k, 1, 0] = 1.0
            return
        border, rest = xi_ids[: m - 1], xi_ids[m - 1:]
        sign = (-1.0) ** len(xi_ids)
        for i in range(m - 1):
            j = m - 2 - i
            basis[border[i], m - 1, j] = -sign
            basis[border[i], j, m - 1] = sign
            sign = -sign
        fill(m - 1, rest)

    fill(n, list(range(d)))
    return basis


@lru_cache(maxsize=None)
def _basis_tensor(n: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(_hat_basis(n), dtype=dtype, device=device)


def hat(xi, n=None):
    """[..., d] -> skew-symmetric [..., n, n]."""
    n = n or ambient_dim(xi.shape[-1])
    return torch.einsum("...k,kij->...ij", xi,
                        _basis_tensor(n, xi.dtype, xi.device))


def vee(W):
    """Inverse of hat: [..., n, n] -> [..., d] (the basis elements are
    orthogonal with squared norm 2)."""
    n = W.shape[-1]
    return torch.einsum("...ij,kij->...k", W,
                        _basis_tensor(n, W.dtype, W.device)) / 2.0


def identity(n: int, *, device, dtype):
    return torch.eye(n, device=device, dtype=dtype)


def expmap(xi, n=None):
    """exp(hat(xi)) by the Hermitian eigendecomposition of i hat(xi):
    W = Q diag(-i lam) Q^H, so exp(W) = Q diag(exp(-i lam)) Q^H."""
    n = n or ambient_dim(xi.shape[-1])
    W = hat(xi, n)
    cdt = torch.complex64 if W.dtype == torch.float32 else torch.complex128
    lam, Q = torch.linalg.eigh(1j * W.to(cdt))
    E = (Q * torch.exp(-1j * lam)[..., None, :]) @ Q.conj().transpose(-1, -2)
    return E.real.to(W.dtype)


def logmap(R):
    """Principal log of one R in SO(n), by numpy's complex eig on the host
    (as the JAX package does; the certification paths call it there)."""
    lam, Q = np.linalg.eig(R.detach().cpu().numpy().astype(np.complex128))
    L = Q @ np.diag(np.log(lam)) @ np.linalg.inv(Q)
    W = np.real(L)
    W = (W - W.T) / 2.0
    return vee(torch.as_tensor(W, dtype=R.dtype, device=R.device))


def cayley(W):
    """(I - W/2)^{-1} (I + W/2), the reference's Cayley chart (SOn.h:160)."""
    eye = torch.eye(W.shape[-1], dtype=W.dtype, device=W.device)
    return solve_small(eye - W / 2.0, eye + W / 2.0)


def cayley_inverse(C):
    """W with cayley(W) = C: W = 2 (C - I)(C + I)^{-1}."""
    eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
    W = 2.0 * solve_small((C + eye).transpose(-1, -2),
                          (C - eye).transpose(-1, -2)).transpose(-1, -2)
    return (W - W.transpose(-1, -2)) / 2.0


def retract(R, xi):
    return R @ cayley(hat(xi, R.shape[-1]))


def local(R1, R2):
    return vee(cayley_inverse(R1.transpose(-1, -2) @ R2))


def compose(R1, R2):
    return R1 @ R2


def inverse(R):
    return R.transpose(-1, -2)


def between(R1, R2):
    return R1.transpose(-1, -2) @ R2


def register_son(n: int) -> manifolds.Manifold:
    """Get-or-create the 'son<n>' manifold (reference: SOn fixed and
    dynamic)."""
    name = f"son{n}"
    try:
        return manifolds.get(name)
    except KeyError:
        pass
    m = manifolds.Manifold(
        name, tangent_dim(n), (n, n), retract, local,
        lambda *, device, dtype, n=n: torch.eye(n, device=device,
                                                dtype=dtype))
    return manifolds.register(m)


SO4 = register_son(4)
