"""Long-tail reference-example parity suite: one file, eleven subcommands.

    python -m gtsam_personal_tpu_torch.tools.parity_suite [NAME ...]
        [--device cuda]

JAX counterpart: examples/parity_suite.py, with the same subcommands and
printed lines. Each function mirrors a reference example end to end and
asserts its known outcome:

  gnc              GNCExample.cpp
  lago             Pose2SLAMExample_lago.cpp (noisyToyGraph.txt)
  spcg             Pose2SLAMwSPCG.cpp (LM with the subgraph PCG solver)
  lost             TriangulationLOSTExample.cpp (DLT vs LOST, noisy trials)
  fisheye          FisheyeExample.cpp (Cal3Fisheye SfM)
  combined_imu     CombinedImuFactorsExample.cpp (per-keyframe bias chain)
  kalman_easy      easyPoint2KalmanFilter.cpp (closed-form KF)
  kalman_elaborate elaboratePoint2KalmanFilter.cpp (KF via elimination)
  essential_view   EssentialViewGraphExample.cpp (essential transfer)
  metis            METISOrderingExample.cpp (fill-reducing ordering)
  pose3_chordal    Pose3SLAMExample_initializePose3Chordal.cpp

With no NAME it runs all of them, then prints PARITY-SUITE OK. `lago` and
`pose3_chordal` read noisyToyGraph.txt and pose3example.txt through
slam/dataset.py:find_example_data (chip_smoke.py:write_noisy_toy_graph and
write_pose3_example write stand-ins). `combined_imu` integrates each
keyframe's IMU segment with navigation/preintegration.py:integrate, which
launches the preint_tangent kernel on the card. The device is the card
unless `--device cpu` asks for the CPU; float64. Each function takes
(device, say) and returns a record of what it measured.
"""

import argparse

import numpy as np
import scipy.sparse as sp
import torch

from gtsam_personal_tpu_torch import config, native
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import Layout, values_from_numpy
from gtsam_personal_tpu_torch.geometry import (cameras, extra, se3,
                                               triangulation as tri)
from gtsam_personal_tpu_torch.linear import subgraph
from gtsam_personal_tpu_torch.linear.kalman import GaussianState, kf_run
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.navigation import (factors as nav, navstate,
                                                 preintegration as pre)
from gtsam_personal_tpu_torch.navigation.scenario import (
    ConstantTwistScenario)
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.gnc import GncParams, optimize_gnc
from gtsam_personal_tpu_torch.nonlinear.marginals import Marginals
from gtsam_personal_tpu_torch.slam import dataset, factors as F
from gtsam_personal_tpu_torch.slam.factors import essential_transfer_residual
from gtsam_personal_tpu_torch.slam.initialize import (chordal_init,
                                                      lago_init_2d)
from gtsam_personal_tpu_torch.tools.view_graph import EDGES, K
from gtsam_personal_tpu_torch.tools.visual_isam2 import CAL, make_scene

F64 = torch.float64


def _np(x):
    return x.detach().cpu().numpy()


def _build(gb, dev):
    return gb.build(device=dev, dtype=F64)


def _values(blocks, dev):
    return values_from_numpy(blocks, device=dev, dtype=F64)


def gnc(device="cuda", say=print):
    """GNCExample.cpp: a 3-pose odometry chain through GNC-TLS; with no
    outliers every weight stays 1 and GNC lands on the LM optimum."""
    dev = config.device(device)
    gb = GraphBuilder()
    F.add_prior(gb, "se2", 0, np.zeros(3), F.diag_noise([0.1] * 3))
    F.add_between(gb, "se2", 0, 1, np.array([1.0, 0.0, 0.1]),
                  F.diag_noise([0.2] * 3))
    F.add_between(gb, "se2", 1, 2, np.array([0.0, 1.0, 0.1]),
                  F.diag_noise([0.4] * 3))
    graph = _build(gb, dev)
    init = _values({"se2": [[0.2, 0.5, -0.1], [0.8, 0.3, 0.1],
                            [0.8, 0.2, 0.3]]}, dev)
    ref = optimizers.optimize_lm(graph, init)
    bi = [i for i, b in enumerate(graph.batches)
          if b.name == "between_se2"][0]
    vals, weights, res = optimize_gnc(graph, init, bi,
                                      GncParams(loss_type="tls"))
    np.testing.assert_allclose(np.asarray(weights), 1.0, atol=1e-6)
    np.testing.assert_allclose(_np(vals["se2"]), _np(ref.values["se2"]),
                               atol=1e-5)
    say(f"gnc: weights all 1, matches LM optimum "
        f"(err {res.error:.3e})  OK")
    return {"se2": _np(vals["se2"]), "weights": np.asarray(weights),
            "error": res.error}


def lago(device="cuda", say=print):
    """Pose2SLAMExample_lago.cpp: LAGO on noisyToyGraph.txt lands in the
    optimum's basin (LM from it reaches the optimum of LM from the file's
    start). The file is read with the AUTO noise format, as the JAX
    subcommand reads it (ROADMAP queue 3 C6)."""
    dev = config.device(device)
    graph, initial = dataset.load_2d(
        dataset.find_example_data("noisyToyGraph.txt"),
        prior_sigmas=(1e-3, 1e-3, 1e-4), device=dev, dtype=F64)
    est = lago_init_2d(graph, initial["se2"].shape[0])
    e_init = float(optimizers.graph_error(graph, initial))
    e_lago = float(optimizers.graph_error(graph, est))
    res_ref = optimizers.optimize_lm(graph, initial)
    res_lago = optimizers.optimize_lm(graph, est)
    assert abs(res_lago.error - res_ref.error) < \
        1e-6 * max(res_ref.error, 1.0)
    say(f"lago: error at init {e_init:.4f} -> LAGO {e_lago:.4f}; both "
        f"LM runs reach {res_ref.error:.6f}  OK")
    return {"lago": _np(est["se2"]), "e_init": e_init, "e_lago": e_lago,
            "error": res_ref.error, "error_lago": res_lago.error}


def spcg(device="cuda", say=print):
    """Pose2SLAMwSPCG.cpp: the 5-pose loop by Gauss-Newton whose linear
    solves are subgraph-preconditioned CG (the structure-only spanning
    tree, ROADMAP queue 3 C13); it reaches the dense optimum."""
    dev = config.device(device)
    gb = GraphBuilder()
    F.add_prior(gb, "se2", 0, np.zeros(3), F.diag_noise([0.3, 0.3, 0.1]))
    for i in range(4):
        F.add_between(gb, "se2", i, i + 1, np.array([2.0, 0.0, np.pi / 2]),
                      F.diag_noise([0.2, 0.2, 0.1]))
    F.add_between(gb, "se2", 4, 0, np.zeros(3), F.diag_noise([0.2, 0.2, 0.1]))
    graph = _build(gb, dev)
    init = _values({"se2": [[0.5, 0.0, 0.2], [2.3, 0.1, 1.1],
                            [2.1, 1.9, 2.8], [-0.3, 2.5, 4.2],
                            [0.1, -0.7, 5.8]]}, dev)
    ref = optimizers.optimize_lm(graph, init)
    values = init
    masks = subgraph.build_spanning_tree_selection(graph.batches, {"se2": 5})
    layout = Layout.of(values)
    err = float(optimizers.graph_error(graph, values))
    for _ in range(15):                      # GN with SPCG inner solves
        delta = subgraph.solve_spcg(linearize(graph, values), masks, layout,
                                    lam=1e-9, maxiter=50, tol=1e-12)
        trial = values.retract(delta)
        e = float(optimizers.graph_error(graph, trial))
        if not np.isfinite(e) or e > err:
            break
        values, err = trial, e
    assert err < ref.error + 1e-8, (err, ref.error)
    say(f"spcg: subgraph-PCG LM error {err:.3e} == dense optimum "
        f"{ref.error:.3e}  OK")
    return {"se2": _np(values["se2"]), "error": err, "dense": ref.error}


def lost(device="cuda", say=print):
    """TriangulationLOSTExample.cpp: DLT and LOST over 500 cameras with
    1e-2 measurement noise, 25 trials; both recover the landmark, LOST at
    least as well on average."""
    dev = config.device(device)
    rng = np.random.default_rng(42)
    n_cams, point, sigma = 500, np.array([0.0, 0.0, 10.0]), 1e-2
    centers = np.stack([rng.uniform(-10, 10, n_cams),
                        rng.uniform(-10, 10, n_cams),
                        rng.uniform(-20, 0, n_cams)], axis=1)
    poses = np.zeros((n_cams, 3, 4))
    poses[:, :, :3] = np.eye(3)
    poses[:, :, 3] = centers
    pc = point[None, :] - centers       # identity calibration
    meas = pc[:, :2] / pc[:, 2:3]
    poses_t = torch.tensor(poses, device=dev)
    errs_dlt, errs_lost = [], []
    for _ in range(25):
        noisy = torch.tensor(meas + rng.normal(scale=sigma, size=meas.shape),
                             device=dev)
        p_dlt = _np(tri.triangulate_dlt(poses_t, noisy)[0])
        p_lost = _np(tri.triangulate_lost(poses_t, noisy, sigma=sigma)[0])
        errs_dlt.append(np.linalg.norm(p_dlt - point))
        errs_lost.append(np.linalg.norm(p_lost - point))
    m_dlt, m_lost = np.mean(errs_dlt), np.mean(errs_lost)
    assert m_lost < 0.1 and m_dlt < 0.5, (m_lost, m_dlt)
    assert m_lost <= m_dlt * 1.05, (m_lost, m_dlt)
    say(f"lost: mean landmark error DLT {m_dlt:.4f}, LOST {m_lost:.4f} "
        f"(500 cams, sigma {sigma})  OK")
    return {"dlt": np.asarray(errs_dlt), "lost": np.asarray(errs_lost)}


def _fisheye_residual(xs, meas):
    pose, point = xs
    return cameras.project_point(pose, point, meas["cal"],
                                 "cal3fisheye") - meas["measured"]


def _point_prior(xs, m):
    return xs[0] - m["prior"]


FISHEYE_CAL = np.array([278.66, 278.48, 0.0, 319.75, 241.96,
                        -0.013721808247486035, 0.020727425669427896,
                        -0.012786476702685545, 0.0025242267320687625])
DPOSE = np.r_[[-0.1, 0.2, 0.25], [0.05, -0.10, 0.20]]
DPOINT = np.array([-0.25, 0.20, 0.15])


def fisheye(device="cuda", say=print):
    """FisheyeExample.cpp: the cube and circle rig through a Cal3Fisheye
    camera, LM from perturbed starts back to ~zero error."""
    dev = config.device(device)
    poses, points = make_scene(8, 8)
    uv = cameras.project_point(torch.tensor(poses)[:, None],
                               torch.tensor(points)[None],
                               torch.tensor(FISHEYE_CAL),
                               "cal3fisheye").numpy()
    gb = GraphBuilder()
    F.add_prior(gb, "se3", 0, poses[0],
                F.diag_noise([0.1] * 3 + [0.3] * 3))
    gb.add("point_prior", _point_prior, ("point3",), 3, [0],
           {"prior": points[0]}, F.diag_noise([0.1] * 3))
    for i in range(len(poses)):
        for j in range(len(points)):
            gb.add("proj_fisheye", _fisheye_residual, ("se3", "point3"), 2,
                   [i, j], {"measured": uv[i, j], "cal": FISHEYE_CAL},
                   F.diag_noise([1.0, 1.0]))
    graph = _build(gb, dev)
    initial = _values({"se3": se3.retract(torch.tensor(poses),
                                          torch.tensor(DPOSE)).numpy(),
                       "point3": points + DPOINT}, dev)
    e0 = float(optimizers.graph_error(graph, initial))
    res = optimizers.optimize_lm(graph, initial,
                                 optimizers.Params(max_iterations=50))
    assert res.error < 1e-8, res.error
    np.testing.assert_allclose(_np(res.values["point3"]), points, atol=1e-4)
    say(f"fisheye: error {e0:.1f} -> {res.error:.2e}, landmarks "
        f"recovered  OK")
    return {"e0": e0, "error": res.error, "point3": _np(res.values["point3"])}


def _vec_prior(xs, m):
    return xs[0] - m["prior"]


def combined_imu(device="cuda", say=print):
    """CombinedImuFactorsExample.cpp: an IMU keyframe chain with a bias
    variable per keyframe, joined by 6-way CombinedImuFactors (the bias
    random walk inside the factor), GPS on every second keyframe; LM
    recovers the keyframe positions. The record's 'segments' are each
    keyframe's (accs, gyros, dts) as integrated."""
    dev = config.device(device)
    params = pre.PreintegrationParams.make_shared_u(
        g=9.81, accel_sigma=0.02, gyro_sigma=0.002, device=dev)
    scen = ConstantTwistScenario(np.array([0.0, 0.0, 0.2]),
                                 np.array([1.5, 0.0, 0.0]))
    n_seg, seg_t, dt = 6, 0.5, 0.005
    rng = np.random.default_rng(1)
    gravity = _np(params.gravity)
    gb = GraphBuilder()
    states = [scen.nav_state(seg_t * k) for k in range(n_seg + 1)]
    F.add_prior(gb, "se3", 0, _np(navstate.pose_of(states[0])),
                F.diag_noise([1e-3] * 6))
    gb.add("vel_prior", _vec_prior, ("vel3",), 3, [0],
           {"prior": _np(navstate.velocity(states[0]))},
           F.diag_noise([1e-3] * 3))
    gb.add("bias_prior", _vec_prior, ("imu_bias",), 6, [0],
           {"prior": np.zeros(6)}, F.diag_noise([1e-2] * 6))
    w, v = scen.omega_b, scen.v_b
    nmeas = int(round(seg_t / dt))
    segments = []
    for k in range(n_seg):
        R = se3.rotation(scen.pose(seg_t * k + np.arange(nmeas) * dt))
        R = _np(R)
        accs, gyros = [], []
        for s in range(nmeas):
            accs.append(np.cross(w, v) - R[s].T @ gravity
                        + rng.normal(scale=0.02, size=3))
            gyros.append(w + rng.normal(scale=0.002, size=3))
        seg = (np.asarray(accs), np.asarray(gyros), np.full(nmeas, dt))
        segments.append(seg)
        pim = pre.integrate(params, torch.zeros(6, device=dev, dtype=F64),
                            *(torch.tensor(a, device=dev) for a in seg))
        nav.add_combined_imu_factor(gb, k, k + 1, k, k + 1, pim, params)
        if (k + 1) % 2 == 0:
            pos = _np(navstate.position(states[k + 1]))
            nav.add_gps_factor(gb, k + 1,
                               pos + rng.normal(scale=0.05, size=3),
                               F.diag_noise([0.05] * 3))
    graph = _build(gb, dev)
    poses = np.stack([_np(navstate.pose_of(s)) for s in states])
    vels = np.stack([_np(navstate.velocity(s)) for s in states])
    poses_init = poses.copy()
    poses_init[1:, :, 3] += rng.normal(scale=0.3, size=(n_seg, 3))
    initial = _values({
        "se3": poses_init,
        "vel3": vels + rng.normal(scale=0.2, size=vels.shape),
        "imu_bias": np.zeros((n_seg + 1, 6))}, dev)
    res = optimizers.optimize_lm(graph, initial)
    err = np.linalg.norm(_np(res.values["se3"])[:, :, 3] - poses[:, :, 3],
                         axis=1)
    assert err.max() < 0.2, err
    say(f"combined_imu: {n_seg} keyframes, per-keyframe bias chain, max "
        f"position error {err.max():.4f} m  OK")
    return {"se3": _np(res.values["se3"]), "error": res.error,
            "max_err": float(err.max()), "segments": segments}


def _kalman_reference():
    """Closed-form 3-step KF of easyPoint2KalmanFilter (numpy oracle)."""
    x, P = np.zeros(2), np.eye(2) * 0.01          # sigmas 0.1
    Fm = Bm = H = np.eye(2)
    Q, R = np.eye(2) * 0.01, np.eye(2) * 0.0625    # sigma 0.25
    for step in range(1, 4):
        u, z = np.array([1.0, 0.0]), np.array([float(step), 0.0])
        x = Fm @ x + Bm @ u
        P = Fm @ P @ Fm.T + Q
        S = H @ P @ H.T + R
        K = P @ H.T @ np.linalg.inv(S)
        x = x + K @ (z - H @ x)
        P = (np.eye(2) - K @ H) @ P
    return x, P


def kalman_easy(device="cuda", say=print):
    """easyPoint2KalmanFilter.cpp: a Point2 moving right 1 unit a step, 3
    predict / update cycles; the final state (3, 0) with the closed-form
    covariance."""
    dev = config.device(device)
    x_ref, P_ref = _kalman_reference()

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)
    eye = t(np.eye(2))
    final, _ = kf_run(GaussianState(t(np.zeros(2)), eye * 0.01), eye, eye,
                      eye * 0.01, eye, eye * 0.0625,
                      t(np.tile([1.0, 0.0], (3, 1))),
                      t([[1.0, 0.0], [2.0, 0.0], [3.0, 0.0]]))
    mean, cov = _np(final.mean), _np(final.cov)
    np.testing.assert_allclose(mean, [3.0, 0.0], atol=1e-10)
    np.testing.assert_allclose(mean, x_ref, atol=1e-10)
    np.testing.assert_allclose(cov, P_ref, atol=1e-10)
    say(f"kalman_easy: final mean {np.round(mean, 6)}, "
        f"cov[0,0] {float(cov[0, 0]):.6f} == closed form  OK")
    return {"mean": mean, "cov": cov}


def _motion(xs, m):
    return xs[1] - xs[0] - m["u"]


def _meas(xs, m):
    return xs[0] - m["z"]


def kalman_elaborate(device="cuda", say=print):
    """elaboratePoint2KalmanFilter.cpp: the same filter as factor-graph
    elimination, a 4-state linear chain; the smoothed last state and its
    marginal covariance equal the filter's."""
    dev = config.device(device)
    x_ref, P_ref = _kalman_reference()
    gb = GraphBuilder()
    gb.add("prior", _vec_prior, ("point2",), 2, [0], {"prior": np.zeros(2)},
           F.diag_noise([0.1, 0.1]))
    for k in range(3):
        gb.add("motion", _motion, ("point2", "point2"), 2, [k, k + 1],
               {"u": np.array([1.0, 0.0])}, F.diag_noise([0.1, 0.1]))
        gb.add("meas", _meas, ("point2",), 2, [k + 1],
               {"z": np.array([float(k + 1), 0.0])},
               F.diag_noise([0.25, 0.25]))
    graph = _build(gb, dev)
    res = optimizers.optimize_gn(graph, _values({"point2": np.zeros((4, 2))},
                                                dev),
                                 optimizers.Params(max_iterations=2))
    last = _np(res.values["point2"])[-1]
    np.testing.assert_allclose(last, x_ref, atol=1e-10)
    P = _np(Marginals(graph, res.values).marginal_covariance("point2", 3))
    np.testing.assert_allclose(P, P_ref, atol=1e-10)
    say(f"kalman_elaborate: graph-elimination posterior == KF "
        f"(mean {np.round(last, 6)})  OK")
    return {"mean": last, "cov": P}


def essential_view(device="cuda", say=print):
    """EssentialViewGraphExample.cpp: 4 circle poses, 8 cube points; the 8
    edges' essential matrices from EssentialTransferFactors (calibrated
    transfer across view triplets), LM from perturbed truth. The unit3
    retraction keeps the reference's cos(1) (ROADMAP queue 3 C5)."""
    dev = config.device(device)
    poses, points = make_scene(4, 8)
    P = torch.tensor(poses)
    pix = cameras.project_point(P[:, None], torch.tensor(points)[None],
                                torch.tensor(CAL)).numpy()      # [4, 8, 2]
    eix = {e: i for i, e in enumerate(EDGES)}

    def edge_var(a, b):
        """(edge index, transpose flag) of E_ab."""
        if (a, b) in eix:
            return eix[(a, b)], False
        return eix[(b, a)], True

    gb = GraphBuilder()
    for a in range(4):
        bb, c = (a + 1) % 4, (a + 2) % 4
        for (i, j, k) in ((a, bb, c), (a, c, bb), (c, bb, a)):
            # transfer INTO view k from views i and j (a factor over the
            # edges (k, i) and (k, j); reference tuples1/2/3)
            v1, t1 = edge_var(k, i)
            v2, t2 = edge_var(k, j)
            for m in range(8):
                gb.add("etransfer", essential_transfer_residual,
                       ("essential", "essential"), 2, [v1, v2],
                       {"pa": pix[i, m], "pb": pix[j, m], "pc": pix[k, m],
                        "Ka": K, "Kb": K, "Kc": K,
                        "transpose1": np.asarray(t1),
                        "transpose2": np.asarray(t2)},
                       F.diag_noise([1.0, 1.0]))
    graph = _build(gb, dev)
    aTb = se3.between(P[[a for a, _ in EDGES]],
                      P[[b for _, b in EDGES]]).numpy()
    truth = np.concatenate([aTb[:, :, :3], (aTb[:, :, 3] / np.linalg.norm(
        aTb[:, :, 3], axis=1, keepdims=True))[:, :, None]], axis=2)
    init_E = extra.essential_retract(torch.tensor(truth), torch.full(
        (len(EDGES), 5), 1e-2, dtype=F64)).numpy()
    initial = _values({"essential": init_E}, dev)
    e0 = float(optimizers.graph_error(graph, initial))
    res = optimizers.optimize_lm(
        graph, initial,
        optimizers.Params(max_iterations=100, relative_error_tol=1e-14,
                          absolute_error_tol=1e-14))
    assert res.error < 1e-8, res.error
    got = _np(res.values["essential"])
    dE = extra.essential_local(torch.tensor(truth), torch.tensor(got))
    for i in range(8):
        assert np.abs(_np(dE[i])).max() < 1e-4, (i, dE[i])
    say(f"essential_view: 8 essential matrices from 96 transfer factors, "
        f"err {e0:.2e} -> {res.error:.2e}, all match truth  OK")
    return {"e0": e0, "error": res.error, "essential": got}


def metis(device="cuda", say=print):
    """METISOrderingExample.cpp analogue: a fill-reducing ordering from the
    native symbolic layer on a 10x10 grid; a permutation with less
    symbolic fill than the identity ordering. Host work: `device` is
    checked and not used."""
    config.device(device)
    n = 10
    N = n * n
    rows, cols = [], []           # the JAX suite's order of the entries
    for i in range(n):
        for j in range(n):
            u = i * n + j
            if j + 1 < n:
                rows += [u, u + 1]
                cols += [u + 1, u]
            if i + 1 < n:
                rows += [u, u + n]
                cols += [u + n, u]
    A = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(N, N))

    def fill(order):
        """Symbolic elimination fill count under `order`."""
        pos = np.empty(N, dtype=np.int64)
        pos[order] = np.arange(N)
        adj = [set(A.indices[A.indptr[u]:A.indptr[u + 1]]) for u in range(N)]
        total = 0
        for u in order:
            nb = [x for x in adj[u] if pos[x] > pos[u]]
            total += len(nb)
            for x in nb:
                adj[x].update(y for y in nb if y != x)
        return total

    order = np.asarray(native.min_degree_order(A.indptr.astype(np.int64),
                                               A.indices.astype(np.int64)))
    assert sorted(order.tolist()) == list(range(N))
    f_md, f_id = fill(order), fill(np.arange(N))
    assert f_md < f_id, (f_md, f_id)
    say(f"metis: min-degree ordering fill {f_md} < identity fill {f_id} "
        f"on the 10x10 grid  OK")
    return {"order": order, "fill": f_md, "fill_identity": f_id}


def pose3_chordal(device="cuda", say=print):
    """Pose3SLAMExample_initializePose3Chordal.cpp: chordal initialization
    on pose3example.txt lands in the optimum's basin."""
    dev = config.device(device)
    graph, initial = dataset.load_3d(
        dataset.find_example_data("pose3example.txt"), device=dev, dtype=F64)
    est = chordal_init(graph, initial["se3"].shape[0])
    e_chordal = float(optimizers.graph_error(graph, est))
    res_file = optimizers.optimize_lm(graph, initial)
    res_chordal = optimizers.optimize_lm(graph, est)
    assert abs(res_chordal.error - res_file.error) < \
        1e-4 * max(res_file.error, 1.0), (res_chordal.error, res_file.error)
    say(f"pose3_chordal: chordal init error {e_chordal:.4f}; LM reaches "
        f"{res_chordal.error:.6f} (== file-init optimum "
        f"{res_file.error:.6f})  OK")
    return {"chordal": _np(est["se3"]), "e_chordal": e_chordal,
            "error": res_file.error, "error_chordal": res_chordal.error}


ALL = dict(gnc=gnc, lago=lago, spcg=spcg, lost=lost, fisheye=fisheye,
           combined_imu=combined_imu, kalman_easy=kalman_easy,
           kalman_elaborate=kalman_elaborate, essential_view=essential_view,
           metis=metis, pose3_chordal=pose3_chordal)


def run(names=None, device="cuda", say=print):
    """Run the named subcommands (all by default) in order; returns
    {name: record}. A failed check raises AssertionError, as in the JAX
    suite."""
    out = {name: ALL[name](device, say) for name in (names or list(ALL))}
    say("PARITY-SUITE OK")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help=", ".join(ALL))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.names, a.device)


if __name__ == "__main__":
    main()
