"""The chain preconditioner's numerics: block-Thomas factorization of a
block-tridiagonal SPD system and its solve by two parallel-prefix scans.

JAX counterpart: gtsam_personal_tpu/nonlinear/isam2.py:_chain_factorize and
_chain_factorize_m (the `lax.scan` of each), _mm_unrolled, _mv_unrolled,
_affine_scan, _chain_apply (lines 799-821 and 890-962). Blocks are
`[cap, d, d]` and vectors `[cap, d]` here; the JAX package keeps them
feature-major (`[d*d, cap]`, `[d, cap]`) for the TPU's tiles.

`chain_factorize` launches the hand-written CUDA kernel
(csrc/chain_factorize.cu) for CUDA tensors and raises if it cannot; it takes
the plain version, a Python loop over the chain, only for tensors on the
CPU. The recurrence is nonlinear in the carried block, so it has no
vectorised torch form.

The scans run in torch operators (`scan_template`, `scan_apply`): eager
torch has no `associative_scan`, so the scan is written out as log2(N)
levels of one batched product each. A float32 matrix product on the card is
a true float32 product (config.py turns TF32 off), so `torch.bmm` stands
where the JAX package unrolls small products to keep them off the TPU's bf16
matrix unit.
"""

import torch

from gtsam_personal_tpu_torch.ops import _build

CHAIN_BLOCK_SIZES = (3, 4, 6, 15)   # instantiated in csrc/chain_factorize.cu


def chain_prepare(D, O, nvar: int, lam):
    """What the factorization takes, from the harvested blocks: D [cap, d, d]
    plus (lam + 1e-12) I on the `nvar` active blocks and the identity on the
    padding; O [cap, d, d] (O_i couples i and i+1) zeroed from nvar - 1 on."""
    cap, d, _ = D.shape
    eye = torch.eye(d, dtype=D.dtype, device=D.device)
    pos = torch.arange(cap, device=D.device)
    Dm = torch.where((pos < nvar)[:, None, None], D + (lam + 1e-12) * eye,
                     eye)
    Om = torch.where((pos < nvar - 1)[:, None, None], O, torch.zeros_like(O))
    return Dm, Om


def chain_factorize_ref(Dm, Om):
    """Plain version: the recurrence Uinv_i = inv(D_i - O_{i-1}^T Uinv_{i-1}
    O_{i-1}) as a loop over the chain."""
    cap = Dm.shape[0]
    out = []
    prev = torch.zeros_like(Dm[0])
    for i in range(cap):
        if i == 0:
            Dt = Dm[0]
        else:
            Dt = Dm[i] - Om[i - 1].T @ (prev @ Om[i - 1])
        prev = torch.linalg.inv(Dt)
        out.append(prev)
    return torch.stack(out) if out else torch.empty_like(Dm)


def _check(Dm, Om):
    if not (isinstance(Dm, torch.Tensor) and isinstance(Om, torch.Tensor)):
        raise TypeError("Dm and Om must be tensors")
    if Dm.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype {Dm.dtype} not supported (float32, float64)")
    if Om.dtype != Dm.dtype:
        raise TypeError(f"dtypes differ: Dm {Dm.dtype}, Om {Om.dtype}")
    if Om.device != Dm.device:
        raise ValueError(f"devices differ: Dm {Dm.device}, Om {Om.device}")
    if Dm.dim() != 3 or Dm.shape[1] != Dm.shape[2] or Om.shape != Dm.shape:
        raise ValueError(f"shapes: Dm {tuple(Dm.shape)} and Om "
                         f"{tuple(Om.shape)} must both be [cap, d, d]")
    if not (Dm.is_contiguous() and Om.is_contiguous()):
        raise ValueError("Dm and Om must be contiguous")


def chain_factorize(Dm, Om):
    """Uinv [cap, d, d] with Uinv_i = inv(Dm_i - Om_{i-1}^T Uinv_{i-1}
    Om_{i-1}) and Uinv_{-1} = 0, for Dm, Om [cap, d, d] as `chain_prepare`
    gives them; float32 or float64, contiguous. On a CUDA device d must be
    one of CHAIN_BLOCK_SIZES. Counts each kernel launch in
    `chain_factorize.launches`."""
    _check(Dm, Om)
    if Dm.device.type == "cpu":
        return chain_factorize_ref(Dm, Om)
    if Dm.device.type != "cuda":
        raise ValueError(f"no kernel for device {Dm.device}")
    cap, d, _ = Dm.shape
    if d not in CHAIN_BLOCK_SIZES:
        raise ValueError(f"the kernel is built for blocks of size "
                         f"{CHAIN_BLOCK_SIZES}, not {d}")
    lib = _build.load()
    fn = (lib.chain_factorize_f32 if Dm.dtype == torch.float32
          else lib.chain_factorize_f64)
    Uinv = torch.empty_like(Dm)
    if cap == 0:
        return Uinv
    # the kernel copies D and O in bulk, from 16-byte boundaries
    Dm, Om = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (Dm, Om))
    with torch.cuda.device(Dm.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(Dm.data_ptr(), Om.data_ptr(), Uinv.data_ptr(), cap, d,
                stream)
    if rc != 0:
        raise RuntimeError(f"chain_factorize kernel launch failed: "
                           f"cudaError {rc}")
    chain_factorize.launches += 1
    return Uinv


chain_factorize.launches = 0


def scan_template(M, reverse: bool = False):
    """What `scan_apply` needs of the matrices M [N, d, d] of a recurrence
    z_i = M_i z_{i-1} + c_i: the affine matrices [[M_i, 0], [0, 1]] with P
    identities before them (after them for `reverse`), [P + N, d+1, d+1],
    P being the largest power of two below N. It depends on M alone, so a
    caller that scans many right-hand sides with one M builds it once."""
    N, d, _ = M.shape
    P = 1
    while 2 * P < N:
        P *= 2
    if N <= 1:
        P = 0
    T = torch.eye(d + 1, dtype=M.dtype, device=M.device).repeat(P + N, 1, 1)
    lo = 0 if reverse else P
    T[lo:lo + N, :d, :d] = M
    return T


def scan_apply(template, c, reverse: bool = False):
    """All z_i [N, d] of z_i = M_i z_{i-1} + c_i (z_{-1} = 0; with
    `reverse`, z_i = M_i z_{i+1} + c_i from the far end) for c [N, d] and
    the `scan_template` of M, as an inclusive scan of log2(N) levels.

    The pair (M, c) is carried as the affine matrix [[M, c], [0, 1]], so the
    JAX package's combine, (Mb Ma, Mb ca + cb), is one batched product:
    level `off` multiplies element i by element i - off (i + off in
    reverse). The identities of the padding stand where i - off falls off
    the chain, so a level is ONE product over all N elements, with nothing
    to copy, and two buffers alternate so that no level reads what it
    writes: 3 + log2(N) launches a scan."""
    N, d = c.shape
    P = template.shape[0] - N
    lo = 0 if reverse else P
    A = template.clone()
    A[lo:lo + N, :d, d] = c
    B = template.clone()        # its padding must hold identities too
    off = 1
    while off < N:
        src = A[lo + off:lo + off + N] if reverse else A[lo - off:lo - off + N]
        torch.bmm(A[lo:lo + N], src, out=B[lo:lo + N])
        A, B = B, A
        off *= 2
    return A[lo:lo + N, :d, d]


def affine_scan(M, c, reverse: bool = False):
    """`scan_apply` for one right-hand side: z_i = M_i z_{i-1} + c_i for
    M [N, d, d], c [N, d]."""
    return scan_apply(scan_template(M, reverse), c, reverse)


def chain_scan_templates(Uinv, Om):
    """The scan templates (forward, backward) of the two recurrences of
    `chain_apply`; they depend on the factorization alone, so a caller that
    applies it many times computes them once."""
    zero = torch.zeros_like(Om[:1])
    Oprev = torch.cat([zero, Om[:-1]])
    Uprev = torch.cat([zero, Uinv[:-1]])   # Oprev_0 = 0: block 0 is unused
    Mf = -torch.bmm(Oprev.transpose(1, 2), Uprev)
    Mb = -torch.bmm(Uinv, Om)
    return scan_template(Mf), scan_template(Mb, reverse=True)


def chain_apply(Uinv, Tf, Tb, r):
    """Solve the factorized tridiagonal system for r [cap, d], with the
    templates of `chain_scan_templates`: forward substitution z_i = r_i -
    O_{i-1}^T Uinv_{i-1} z_{i-1}, then backward x_i = Uinv_i z_i - Uinv_i
    O_i x_{i+1}, each as one affine scan."""
    z = scan_apply(Tf, r)
    cb = torch.bmm(Uinv, z[:, :, None])[:, :, 0]
    return scan_apply(Tb, cb, reverse=True)
