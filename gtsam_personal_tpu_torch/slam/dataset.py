"""Dataset I/O: g2o / TORO / EDGE3 pose-graph files and initial estimates.

JAX counterpart: gtsam_personal_tpu/slam/dataset.py (all of it:
REFERENCE_DATA_DIR and find_example_data :27-37, the directory here taken
from the environment variable GTSAM_EXAMPLE_DATA_DIR, _noise_2d :47-70,
ypr_to_matrix, quat_to_matrix, _se2_compose_chain, load_2d :123-218,
load_3d :221-310, _batch_info, write_g2o_2d, matrix_to_quat, matrix_to_ypr,
write_g2o_3d :313-420; reference: gtsam/slam/dataset.cpp).

- 2D: tags VERTEX2/VERTEX_SE2/VERTEX, EDGE2/EDGE/EDGE_SE2/ODOMETRY, BR and
  LANDMARK, with the four noise conventions (dataset.cpp:216-270): G2O/COV
  read the 6 values as the row-major upper triangle of a 3x3 matrix,
  TORO/GRAPH in (ff, fs, ss, rr, fr, sr) order; G2O/TORO take the matrix as
  information, COV/GRAPH as covariance; AUTO guesses from the zero pattern
  of the first edge (dataset.cpp:219).
- 3D: VERTEX3 (x y z roll pitch yaw, dataset.cpp:748-753), VERTEX_SE3:QUAT,
  EDGE3 (information in GTSAM's (R, t) tangent order as it stands) and
  EDGE_SE3:QUAT (information in g2o's (t, R) order, block-swapped into
  (R, t), dataset.cpp:850-856).

Parsing is the JAX package's numpy code, line for line, so the arrays are
bit-identical to its own before they move to the device; the loaders then
build the port's FactorGraph and Values on `device` in `dtype`. The writers
take the port's graph and values, bring them to the host in float64 (the
text of `str` of a float32 differs from that of the same float64) and write
the text the JAX package writes for the same float64 numbers.
"""

import os

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.slam import factors as F

# the reference's examples/Data directory: a deployment path, read from the
# environment (the JAX package hard-codes the place it is mounted)
REFERENCE_DATA_DIR = os.environ.get("GTSAM_EXAMPLE_DATA_DIR")


def find_example_data(name: str) -> str:
    """Analogue of the reference's findExampleDataFile (slam/dataset.h):
    REFERENCE_DATA_DIR when it is set, then ./data, then the working
    directory."""
    bases = ([REFERENCE_DATA_DIR] if REFERENCE_DATA_DIR else []) + ["data",
                                                                    "."]
    for base in bases:
        p = os.path.join(base, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(name)


def _sqrt_info_from_info(info: np.ndarray) -> np.ndarray:
    """Batched: S = L^T with L L^T = info, so S^T S = info."""
    info = 0.5 * (info + np.swapaxes(info, -1, -2))
    L = np.linalg.cholesky(info)
    return np.swapaxes(L, -1, -2)


def _noise_2d(v6: np.ndarray, fmt: str) -> np.ndarray:
    """6-vector rows -> 3x3 information matrices per the reference's
    conventions."""
    K = v6.shape[0]
    if K == 0:
        return np.zeros((0, 3, 3))
    if fmt == "auto":
        r = v6[0]
        if (r[0] != 0 and r[1] == 0 and r[2] != 0 and r[3] != 0
                and r[4] == 0 and r[5] == 0):
            fmt = "graph"
        elif (r[0] != 0 and r[1] == 0 and r[2] == 0 and r[3] != 0
              and r[4] == 0 and r[5] != 0):
            fmt = "cov"
        else:
            fmt = "g2o"
    M = np.zeros((K, 3, 3))
    if fmt in ("g2o", "cov"):
        M[:, 0, 0], M[:, 0, 1], M[:, 0, 2] = v6[:, 0], v6[:, 1], v6[:, 2]
        M[:, 1, 1], M[:, 1, 2], M[:, 2, 2] = v6[:, 3], v6[:, 4], v6[:, 5]
    else:  # toro / graph order: ff fs ss rr fr sr
        M[:, 0, 0], M[:, 0, 1], M[:, 0, 2] = v6[:, 0], v6[:, 1], v6[:, 4]
        M[:, 1, 1], M[:, 1, 2], M[:, 2, 2] = v6[:, 2], v6[:, 5], v6[:, 3]
    M = M + np.triu(M, 1).swapaxes(-1, -2)
    if fmt in ("cov", "graph"):
        M = np.linalg.inv(M)
    return M


def ypr_to_matrix(roll, pitch, yaw):
    """Rot3::Ypr(y, p, r) = Rz(y) Ry(p) Rx(r), vectorized over leading
    dims."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    R = np.empty(np.shape(yaw) + (3, 3))
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


def quat_to_matrix(qx, qy, qz, qw):
    """Unit quaternion -> rotation matrix, vectorized."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    R = np.empty(np.shape(qw) + (3, 3))
    R[..., 0, 0] = 1 - 2 * (qy * qy + qz * qz)
    R[..., 0, 1] = 2 * (qx * qy - qz * qw)
    R[..., 0, 2] = 2 * (qx * qz + qy * qw)
    R[..., 1, 0] = 2 * (qx * qy + qz * qw)
    R[..., 1, 1] = 1 - 2 * (qx * qx + qz * qz)
    R[..., 1, 2] = 2 * (qy * qz - qx * qw)
    R[..., 2, 0] = 2 * (qx * qz - qy * qw)
    R[..., 2, 1] = 2 * (qy * qz + qx * qw)
    R[..., 2, 2] = 1 - 2 * (qx * qx + qy * qy)
    return R


def _se2_compose_chain(edges_ij, edges_meas, n):
    """Initial estimate by composing odometry where no vertices are
    given."""
    poses = np.zeros((n, 3))
    have = np.zeros(n, dtype=bool)
    have[0] = True
    for (i, j), m in zip(edges_ij, edges_meas):
        if have[i] and not have[j] and j == i + 1:
            c, s = np.cos(poses[i, 2]), np.sin(poses[i, 2])
            poses[j, 0] = poses[i, 0] + c * m[0] - s * m[1]
            poses[j, 1] = poses[i, 1] + s * m[0] + c * m[1]
            poses[j, 2] = poses[i, 2] + m[2]
            have[j] = True
    return poses


_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _dev(a, device, dtype=None):
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def _prior_batch(group, rdim, first_pose, prior_sigmas, npd, device, dtype):
    prior_w = (1.0 / np.asarray(prior_sigmas, dtype=npd))[None, :]
    return FactorBatch(
        f"prior_{group}", F.make_prior_residual(group), (group,), rdim,
        torch.zeros((1, 1), dtype=torch.int64, device=device),
        {"prior": _dev(first_pose[None], device, dtype)},
        NoiseModel("diag", _dev(prior_w, device, dtype)))


def load_2d(path, noise_format="auto", prior_sigmas=(0.3, 0.3, 0.1), *,
            device, dtype):
    """Load a 2D pose graph (reference: load2D, slam/dataset.h:152) onto
    `device`. Returns (FactorGraph, Values) with the group "se2" (and
    "point2" for BR/LANDMARK lines); adds a prior on pose 0."""
    npd = _NP[dtype]
    vertices = {}
    eij, emeas, einfo = [], [], []
    br = []   # bearing-range: (pose, landmark, bearing, range, b_std, r_std)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag in ("VERTEX2", "VERTEX_SE2", "VERTEX"):
                vertices[int(parts[1])] = [float(parts[2]), float(parts[3]),
                                           float(parts[4])]
            elif tag in ("EDGE2", "EDGE", "EDGE_SE2", "ODOMETRY"):
                i, j = int(parts[1]), int(parts[2])
                vals = [float(x) for x in parts[3:12]]
                eij.append((i, j))
                emeas.append(vals[:3])
                einfo.append(vals[3:9])
            elif tag == "BR":
                # bearing-range landmark measurement (dataset.cpp:463)
                i, j = int(parts[1]), int(parts[2])
                bearing, rng_, b_std, r_std = map(float, parts[3:7])
                br.append((i, j, bearing, rng_, b_std, r_std))
            elif tag == "LANDMARK":
                # x-y landmark sighting as bearing-range (dataset.cpp:465-486)
                i, j = int(parts[1]), int(parts[2])
                lmx, lmy, v1, v2, v3 = map(float, parts[3:8])
                bearing = np.arctan2(lmy, lmx)
                rng_ = np.hypot(lmx, lmy)
                if abs(v1 - v3) < 1e-4:
                    b_std, r_std = np.sqrt(v1 / 10.0), np.sqrt(v1)
                else:
                    b_std, r_std = 1.0, 1.0
                br.append((i, j, bearing, rng_, b_std, r_std))
    eij = np.asarray(eij, dtype=np.int32).reshape(-1, 2)
    emeas = np.asarray(emeas, dtype=npd).reshape(-1, 3)
    einfo = _noise_2d(np.asarray(einfo).reshape(-1, 6),
                      noise_format).astype(npd)

    n = int(max(eij.max() if eij.size else -1,
                max(vertices) if vertices else -1)) + 1
    if vertices:
        poses = np.zeros((n, 3), dtype=npd)
        for k, v in vertices.items():
            poses[k] = v
    else:
        poses = _se2_compose_chain(eij, emeas, n).astype(npd)

    S = _sqrt_info_from_info(einfo).astype(npd)
    between = FactorBatch(
        "between_se2", F.make_between_residual("se2"), ("se2", "se2"), 3,
        _dev(eij, device, torch.int64), {"measured": _dev(emeas, device,
                                                          dtype)},
        NoiseModel("full", _dev(S, device, dtype)))
    prior = _prior_batch("se2", 3, poses[0], prior_sigmas, npd, device,
                         dtype)

    batches = [prior] + ([between] if len(eij) else [])
    values = {"se2": _dev(poses, device, dtype)}
    if br:
        arr = np.asarray(br, dtype=npd)
        pose_ids = arr[:, 0].astype(np.int32)
        lm_ids_raw = arr[:, 1].astype(np.int64)
        # landmark ids in files are global keys: a dense point2 block
        uniq = np.unique(lm_ids_raw)
        remap = {int(v): k for k, v in enumerate(uniq)}
        lm_ids = np.asarray([remap[int(v)] for v in lm_ids_raw],
                            dtype=np.int32)
        idx = np.stack([pose_ids, lm_ids], axis=1)
        w = np.stack([1.0 / arr[:, 4], 1.0 / arr[:, 5]], axis=1).astype(npd)
        batches.append(FactorBatch(
            "bearing_range_2d", F.bearing_range_2d_residual,
            ("se2", "point2"), 2, _dev(idx, device, torch.int64),
            {"bearing": _dev(arr[:, 2], device, dtype),
             "range": _dev(arr[:, 3], device, dtype)},
            NoiseModel("diag", _dev(w, device, dtype))))
        # landmarks start from their first sighting
        lms = np.zeros((len(uniq), 2), dtype=npd)
        seen = np.zeros(len(uniq), dtype=bool)
        for k in range(len(arr)):
            li = lm_ids[k]
            if not seen[li]:
                p = poses[pose_ids[k]]
                c, s_ = np.cos(p[2] + arr[k, 2]), np.sin(p[2] + arr[k, 2])
                lms[li] = [p[0] + arr[k, 3] * c, p[1] + arr[k, 3] * s_]
                seen[li] = True
        values["point2"] = _dev(lms, device, dtype)

    return FactorGraph(batches), Values(values)


def _info_block(M):
    """The symmetric 6x6 matrix of the 21 upper-triangle values."""
    out = np.zeros((6, 6))
    out[np.triu_indices(6)] = M
    return out + np.triu(out, 1).T


def load_3d(path, prior_sigmas=(0.1, 0.1, 0.1, 0.3, 0.3, 0.3),
            init="compose", *, device, dtype):
    """Load a 3D pose graph in EDGE3 / EDGE_SE3:QUAT form (reference:
    load3D / readG2o 3D, slam/dataset.h:190,209) onto `device`. The group
    is "se3"; a prior is added on pose 0.

    init='compose' chains odometry edges when the file has fewer vertices
    than poses; init='vertices' takes the vertex lines as they are."""
    npd = _NP[dtype]
    vertices = {}
    eij, eT, einfo = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "VERTEX3":
                i = int(parts[1])
                x, y, z, r, p, yw = map(float, parts[2:8])
                R = ypr_to_matrix(r, p, yw)
                vertices[i] = np.concatenate([R, np.array([[x], [y], [z]])],
                                             axis=1)
            elif tag == "VERTEX_SE3:QUAT":
                i = int(parts[1])
                x, y, z, qx, qy, qz, qw = map(float, parts[2:9])
                R = quat_to_matrix(qx, qy, qz, qw)
                vertices[i] = np.concatenate([R, np.array([[x], [y], [z]])],
                                             axis=1)
            elif tag == "EDGE3":
                i, j = int(parts[1]), int(parts[2])
                v = [float(x) for x in parts[3:]]
                x, y, z, r, p, yw = v[:6]
                R = ypr_to_matrix(r, p, yw)
                T = np.concatenate([R, np.array([[x], [y], [z]])], axis=1)
                eij.append((i, j)); eT.append(T)
                einfo.append(_info_block(v[6:27]))
            elif tag == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                v = [float(x) for x in parts[3:]]
                x, y, z, qx, qy, qz, qw = v[:7]
                R = quat_to_matrix(qx, qy, qz, qw)
                T = np.concatenate([R, np.array([[x], [y], [z]])], axis=1)
                M = _info_block(v[7:28])
                # g2o (t,R) -> GTSAM (R,t) block swap (dataset.cpp:850-856)
                G = np.zeros((6, 6))
                G[:3, :3] = M[3:, 3:]
                G[3:, 3:] = M[:3, :3]
                G[3:, :3] = M[:3, 3:]
                G[:3, 3:] = M[3:, :3]
                eij.append((i, j)); eT.append(T); einfo.append(G)

    eij = np.asarray(eij, dtype=np.int32).reshape(-1, 2)
    eT = np.asarray(eT, dtype=npd).reshape(-1, 3, 4)
    einfo = np.asarray(einfo, dtype=npd).reshape(-1, 6, 6)
    n = int(max(eij.max() if eij.size else -1,
                max(vertices) if vertices else -1)) + 1

    # the JAX package's precedence, as it stands (dataset.py:282)
    if vertices and init == "vertices" or (vertices and len(vertices) == n):
        poses = np.zeros((n, 3, 4), dtype=npd)
        for k, v in vertices.items():
            poses[k] = v
    else:
        poses = np.tile(np.eye(3, 4, dtype=npd), (n, 1, 1))
        have = np.zeros(n, dtype=bool)
        have[0] = True
        for (i, j), T in zip(eij, eT):
            if have[i] and not have[j]:
                Ri, ti = poses[i, :, :3], poses[i, :, 3]
                poses[j, :, :3] = Ri @ T[:, :3]
                poses[j, :, 3] = ti + Ri @ T[:, 3]
                have[j] = True

    S = _sqrt_info_from_info(einfo).astype(npd)
    between = FactorBatch(
        "between_se3", F.make_between_residual("se3"), ("se3", "se3"), 6,
        _dev(eij, device, torch.int64), {"measured": _dev(eT, device, dtype)},
        NoiseModel("full", _dev(S, device, dtype)))
    prior = _prior_batch("se3", 6, poses[0], prior_sigmas, npd, device,
                         dtype)
    return (FactorGraph([prior] + ([between] if len(eij) else [])),
            Values({"se3": _dev(poses, device, dtype)}))


def _host(x):
    """A tensor on the host in float64 (integers stay integers)."""
    x = x.detach().cpu()
    return (x.double() if x.is_floating_point() else x).numpy()


def _batch_info(S, kind, k, d):
    """Information matrix of factor k from the host noise data S of a batch
    (any noise kind), with the JAX package's arithmetic (_batch_info), so
    that the text written is the same."""
    if kind == "unit" or S is None:
        return np.eye(d)
    Sk = S if S.ndim == (1 if kind == "diag" else 2) else S[k]
    if kind == "diag":
        return np.diag(np.asarray(Sk) ** 2)
    return Sk.T @ Sk


def _noise_host(b):
    return None if b.noise.data is None else _host(b.noise.data)


def _fmt(values):
    return " ".join(map(str, values))


def write_g2o_2d(path, values: Values, graph: FactorGraph = None):
    """writeG2o analogue, 2D (reference: slam/dataset.cpp writeG2o):
    VERTEX_SE2 lines, then EDGE_SE2 with the upper triangle of each
    between_se2 factor's information matrix."""
    poses = _host(values["se2"])
    iu = np.triu_indices(3)
    with open(path, "w") as f:
        for i, (x, y, th) in enumerate(poses):
            f.write(f"VERTEX_SE2 {i} {x} {y} {th}\n")
        if graph is not None:
            for b in graph.batches:
                if b.name != "between_se2":
                    continue
                ij = _host(b.idx)
                m = _host(b.meas["measured"])
                S = _noise_host(b)
                for k in range(ij.shape[0]):
                    info = _batch_info(S, b.noise.kind, k, 3)
                    f.write(f"EDGE_SE2 {ij[k, 0]} {ij[k, 1]} "
                            + _fmt(m[k]) + " " + _fmt(info[iu]) + "\n")


def matrix_to_quat(R):
    """Rotation matrix -> (qx, qy, qz, qw), Shepperd's method (host)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return qx, qy, qz, qw


def matrix_to_ypr(R):
    """Rotation matrix -> (roll, pitch, yaw), the inverse of
    ypr_to_matrix."""
    R = np.asarray(R, dtype=np.float64)
    pitch = -np.arcsin(np.clip(R[2, 0], -1.0, 1.0))
    roll = np.arctan2(R[2, 1], R[2, 2])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return roll, pitch, yaw


def _to_g2o_order(info):
    """Permute a (R, t) information matrix into g2o's (t, R) order."""
    G = np.zeros((6, 6))
    G[:3, :3] = info[3:, 3:]
    G[3:, 3:] = info[:3, :3]
    G[:3, 3:] = info[3:, :3]
    G[3:, :3] = info[:3, 3:]
    return G


def write_g2o_3d(path, values: Values, graph: FactorGraph = None,
                 fmt: str = "quat"):
    """writeG2o analogue, 3D. fmt='quat' writes VERTEX_SE3:QUAT /
    EDGE_SE3:QUAT with the information matrix permuted into g2o's (t, R)
    order (the inverse of the reader's swap, dataset.cpp:850-856);
    fmt='edge3' writes VERTEX3 / EDGE3 with (x y z roll pitch yaw) and the
    information in GTSAM's (R, t) order as it stands."""
    poses = _host(values["se3"])  # [N, 3, 4]
    iu6 = np.triu_indices(6)
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            x, y, z = T[:, 3]
            if fmt == "quat":
                qx, qy, qz, qw = matrix_to_quat(T[:, :3])
                f.write(f"VERTEX_SE3:QUAT {i} {x} {y} {z} {qx} {qy} {qz} "
                        f"{qw}\n")
            else:
                r, p, yw = matrix_to_ypr(T[:, :3])
                f.write(f"VERTEX3 {i} {x} {y} {z} {r} {p} {yw}\n")
        if graph is None:
            return
        for b in graph.batches:
            if b.name != "between_se3":
                continue
            ij = _host(b.idx)
            m = _host(b.meas["measured"])  # [K, 3, 4]
            S = _noise_host(b)
            for k in range(ij.shape[0]):
                info = _batch_info(S, b.noise.kind, k, 6)   # (R, t) order
                T = m[k]
                x, y, z = T[:, 3]
                if fmt == "quat":
                    qx, qy, qz, qw = matrix_to_quat(T[:, :3])
                    f.write(f"EDGE_SE3:QUAT {ij[k, 0]} {ij[k, 1]} "
                            f"{x} {y} {z} {qx} {qy} {qz} {qw} "
                            + _fmt(_to_g2o_order(info)[iu6]) + "\n")
                else:
                    r, p, yw = matrix_to_ypr(T[:, :3])
                    f.write(f"EDGE3 {ij[k, 0]} {ij[k, 1]} "
                            f"{x} {y} {z} {r} {p} {yw} "
                            + _fmt(info[iu6]) + "\n")
