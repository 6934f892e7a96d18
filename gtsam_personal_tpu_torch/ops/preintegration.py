"""The IMU preintegration scans, batched over segments.

JAX counterpart: gtsam_personal_tpu/navigation/preintegration.py: the
`lax.scan` of `integrate` (:112, its body differentiated by `jax.jacfwd` at
:98-100), of `_manifold_scan` (:171, under `jacfwd` over the bias at :191)
and the two of `integrate_ahrs` (:225 under `jacfwd` at :229, and :240).
Each scan's carry enters nonlinearly, so eager torch has no vectorised form
of it: the plain versions here are Python loops over the samples, batched
over segments, differentiated with `torch.func` as the JAX package does.

`preint_tangent` and `preint_rotation` launch the hand-written CUDA kernels
(csrc/preint_tangent.cu, csrc/preint_rotation.cu) for CUDA tensors and raise
if they cannot; they take the plain versions only for tensors on the CPU.
Segments are [S, N] samples; a shorter segment is padded with samples of
dt = 0, which leave every carried quantity as it is.
"""

import torch

from gtsam_personal_tpu_torch.geometry import so3
from gtsam_personal_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.float64)


def _matvec(A, x):
    return (A @ x[..., None])[..., 0]


# -- plain versions ----------------------------------------------------------

def update_zeta(zeta, a, w, dt):
    """One tangent-space step (TangentPreintegration::UpdatePreintegrated,
    TangentPreintegration.cpp:54): zeta [..., 9], a, w [..., 3], dt [..., 1]."""
    theta, pos, vel = zeta[..., :3], zeta[..., 3:6], zeta[..., 6:9]
    w_tan = _matvec(so3.left_jacobian_inverse(-theta), w)
    a_nav = _matvec(so3.expmap(theta), a)
    dt22 = 0.5 * dt * dt
    return torch.cat([theta + w_tan * dt, pos + vel * dt + a_nav * dt22,
                      vel + a_nav * dt], dim=-1)


_update_jacobians = torch.func.vmap(torch.func.jacfwd(update_zeta,
                                                      argnums=(0, 1, 2)))


def preint_tangent_ref(accs, gyros, dts, bias, covs):
    """Plain version of `preint_tangent`: the loop over the samples, with
    A, B, C from `jacfwd` of `update_zeta` at every step."""
    S, N, _ = accs.shape
    zeta = accs.new_zeros((S, 9))
    H = accs.new_zeros((S, 9, 6))
    cov = accs.new_zeros((S, 9, 9))
    total = accs.new_zeros((S, 1))
    acc_cov, gyro_cov, int_cov = covs
    ba, bw = bias[:, :3], bias[:, 3:]
    for n in range(N):
        a, w, dt = accs[:, n] - ba, gyros[:, n] - bw, dts[:, n, None]
        A, B, C = _update_jacobians(zeta, a, w, dt)
        zeta = update_zeta(zeta, a, w, dt)
        H = A @ H - torch.cat([B, C], dim=-1)
        dt_safe = torch.clamp(dt, min=1e-12)[..., None]
        cov = (A @ cov @ A.transpose(1, 2)
               + B @ (acc_cov / dt_safe) @ B.transpose(1, 2)
               + C @ (gyro_cov / dt_safe) @ C.transpose(1, 2))
        cov[:, 3:6, 3:6] += int_cov * dt[..., None]
        total = total + dt
    return zeta, H, cov, total[:, 0]


def _manifold_scan(bias, accs, gyros, dts):
    """deltaR, deltaP, deltaV of ONE segment composed on the manifold."""
    R = torch.eye(3, dtype=accs.dtype, device=accs.device)
    p = accs.new_zeros(3)
    v = accs.new_zeros(3)
    ba, bw = bias[:3], bias[3:]
    for n in range(accs.shape[0]):
        a, w, dt = accs[n] - ba, gyros[n] - bw, dts[n:n + 1]
        a_nav = _matvec(R, a)
        p = p + v * dt + 0.5 * dt * dt * a_nav
        v = v + a_nav * dt
        R = R @ so3.expmap(w * dt)
    return R, p, v


def _ahrs_scan(bw, gyros, dts):
    R = torch.eye(3, dtype=gyros.dtype, device=gyros.device)
    for n in range(gyros.shape[0]):
        R = R @ so3.expmap((gyros[n] - bw) * dts[n:n + 1])
    return R


def _with_tangents(scan):
    """vmap over segments of (scan(bias), d scan / d bias), the tangents
    direction-major: [S, nb, ...]."""
    def one(bias, *rest):
        out = scan(bias, *rest)
        return out, out
    jac = torch.func.vmap(torch.func.jacfwd(one, has_aux=True))

    def run(bias, *rest):
        tangents, primal = jac(bias, *rest)
        if isinstance(primal, torch.Tensor):
            primal, tangents = (primal,), (tangents,)
        return primal, tuple(torch.movedim(t, -1, 1) for t in tangents)
    return run


_manifold_with_tangents = _with_tangents(_manifold_scan)
_ahrs_with_tangents = _with_tangents(_ahrs_scan)


def ahrs_cov_ref(gyros, dts, bias, gyro_cov):
    """The AHRS covariance scan (integrate_ahrs :231-241), batched."""
    S = gyros.shape[0]
    cov = gyros.new_zeros((S, 3, 3))
    for n in range(gyros.shape[1]):
        dt = dts[:, n, None]
        w = (gyros[:, n] - bias) * dt
        A = so3.expmap(w).transpose(1, 2)
        B = so3.left_jacobian(-w) * dt[..., None]
        dt_safe = torch.clamp(dt, min=1e-12)[..., None]
        cov = (A @ cov @ A.transpose(1, 2)
               + B @ (gyro_cov / dt_safe) @ B.transpose(1, 2))
    return cov


def preint_rotation_ref(mode, gyros, dts, bias, accs=None, gyro_cov=None):
    """Plain version of `preint_rotation`: the scans under `jacfwd` over the
    bias, as the JAX package takes them."""
    if mode == "manifold":
        (R, p, v), (dR, dp, dv) = _manifold_with_tangents(bias, accs, gyros,
                                                          dts)
        return R, p, v, dR, dp, dv
    (R,), (dR,) = _ahrs_with_tangents(bias, gyros, dts)
    return R, dR, ahrs_cov_ref(gyros, dts, bias, gyro_cov)


# -- the kernels ---------------------------------------------------------------

def _check(what, tensors, shapes):
    """Every tensor of one type and device, contiguous, of its shape (None
    in a shape: any size)."""
    first = tensors[0]
    if first.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {first.dtype} not supported "
                        f"(float32, float64)")
    for t, shape in zip(tensors, shapes):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: inputs must be tensors")
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{what}: inputs differ in dtype or device: "
                             f"{t.dtype} {t.device}, {first.dtype} "
                             f"{first.device}")
        if t.dim() != len(shape) or any(
                s is not None and t.shape[k] != s for k, s in enumerate(shape)):
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {first.device}")


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def preint_tangent(accs, gyros, dts, bias, covs):
    """Tangent-space preintegration of S segments of N samples.

    accs, gyros [S, N, 3], dts [S, N], bias [S, 6] (accelerometer, gyro),
    covs [3, 3, 3] (accel, gyro, integration covariance); float32 or
    float64, contiguous, one device. Returns zeta [S, 9], H [S, 9, 6] (the
    bias Jacobians [H_ba | H_bw]), cov [S, 9, 9] and deltaT [S]. Counts each
    kernel launch in `preint_tangent.launches`."""
    S, N = dts.shape
    _check("preint_tangent", (accs, gyros, dts, bias, covs),
           ((S, N, 3), (S, N, 3), (S, N), (S, 6), (3, 3, 3)))
    if accs.device.type == "cpu":
        return preint_tangent_ref(accs, gyros, dts, bias, covs)
    lib = _build.load()
    fn = (lib.preint_tangent_f32 if accs.dtype == torch.float32
          else lib.preint_tangent_f64)
    zeta = accs.new_empty((S, 9))
    H = accs.new_empty((S, 9, 6))
    cov = accs.new_empty((S, 9, 9))
    total = accs.new_empty((S,))
    with torch.cuda.device(accs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(accs.data_ptr(), gyros.data_ptr(), dts.data_ptr(),
                bias.data_ptr(), covs.data_ptr(), zeta.data_ptr(),
                H.data_ptr(), cov.data_ptr(), total.data_ptr(), S, N, stream)
    _raise_on(rc, "preint_tangent")
    preint_tangent.launches += 1
    return zeta, H, cov, total


preint_tangent.launches = 0


def preint_rotation(mode, gyros, dts, bias, accs=None, gyro_cov=None):
    """The rotation-carrying scans of S segments of N samples, with their
    forward-mode tangents in the bias directions.

    mode "manifold": accs, gyros [S, N, 3], dts [S, N], bias [S, 6]; returns
    deltaR [S, 3, 3], deltaP, deltaV [S, 3] and their tangents [S, 6, 3, 3],
    [S, 6, 3], [S, 6, 3] (direction d moves bias component d).
    mode "ahrs": gyros [S, N, 3], dts [S, N], bias [S, 3], gyro_cov [3, 3];
    returns deltaR [S, 3, 3], its tangents [S, 3, 3, 3] and the AHRS
    covariance [S, 3, 3].
    float32 or float64, contiguous, one device. Counts each kernel launch
    in `preint_rotation.launches`."""
    S, N = dts.shape
    if mode == "manifold":
        _check("preint_rotation", (gyros, dts, bias, accs),
               ((S, N, 3), (S, N), (S, 6), (S, N, 3)))
    elif mode == "ahrs":
        _check("preint_rotation", (gyros, dts, bias, gyro_cov),
               ((S, N, 3), (S, N), (S, 3), (3, 3)))
    else:
        raise ValueError(f"mode {mode!r}: 'manifold' or 'ahrs'")
    if gyros.device.type == "cpu":
        return preint_rotation_ref(mode, gyros, dts, bias, accs, gyro_cov)
    lib = _build.load()
    fn = (lib.preint_rotation_f32 if gyros.dtype == torch.float32
          else lib.preint_rotation_f64)
    nd = 6 if mode == "manifold" else 3
    R = gyros.new_empty((S, 3, 3))
    dR = gyros.new_empty((S, nd, 3, 3))
    if mode == "manifold":
        p, v = gyros.new_empty((S, 3)), gyros.new_empty((S, 3))
        dp, dv = gyros.new_empty((S, nd, 3)), gyros.new_empty((S, nd, 3))
        cov = None
        acc_ptr, cov_in = accs.data_ptr(), 0
    else:
        p = v = dp = dv = None
        cov = gyros.new_empty((S, 3, 3))
        acc_ptr, cov_in = 0, gyro_cov.data_ptr()

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    with torch.cuda.device(gyros.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(0 if mode == "manifold" else 1, acc_ptr, gyros.data_ptr(),
                dts.data_ptr(), bias.data_ptr(), cov_in, R.data_ptr(),
                dR.data_ptr(), ptr(p), ptr(v), ptr(dp), ptr(dv), ptr(cov), S,
                N, stream)
    _raise_on(rc, "preint_rotation")
    preint_rotation.launches += 1
    if mode == "manifold":
        return R, p, v, dR, dp, dv
    return R, dR, cov


preint_rotation.launches = 0
