"""Streaming SLAM through nonlinear.isam2.ISAM2.update.

The stream is the configuration's graph, its edges in the order of their
later pose, odometry before closures at one pose (a copy of the port's
tools/profile_isam2.py:stream_data order). Set-up brings an engine to pose
`from_pose`: a batch `lm_run` (solver schur) of the prefix's graph from the
odometry start gives the prefix's start, the engine takes the prefix's poses
and edges staged at once, and updates with `settle_cg` more CG iterations
until an update's CG stops short of its cap (at most `settle_updates`). A
warm-up streams `warmup_updates` measurements on a clone of the engine,
which is then dropped. A request is one measurement: the pose it adds, if
new, starts at the estimate of its earlier pose composed with the
measurement; then one update. Its unit is the update. The stream past
pose 9000 holds 2828 measurements; a window that would outlast them ends
when only the traced stretch's are left.
"""

from types import SimpleNamespace

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import graph_from_numpy
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.linear import schur
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import isam2, optimizers
from gtsam_personal_tpu_torch.slam import factors as F
from portbench.gen import manhattan
from portbench.paths import pose_schur
from portbench.reference import pose_schur as ref


def stream_order(g):
    """The edges' order in the stream: by later pose, odometry first."""
    return np.lexsort((g.ij[:, 1] - g.ij[:, 0] != 1, g.ij.max(axis=1)))


def _compose(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     a[2] + b[2]])


def _prefix_start(g, ij, meas, n, dtype, device, t):
    """The prefix's batch LM result from its odometry start (poses < n)."""
    K = len(ij)
    graph = graph_from_numpy(pose_schur.batches(g, ij, meas, K),
                             pose_schur.residual_by_name, device=device,
                             dtype=dtype)
    values = values_from_numpy({"se2": g.start[:n]}, device=device,
                               dtype=dtype)
    plan = schur.make_plan(graph, {"se2": n},
                           max_part_size=t["prefix_max_part_size"])
    err0 = optimizers.graph_error(graph, values)
    v, _, _ = optimizers.lm_run(graph, values, t["prefix_lambda"], err0,
                                t["prefix_lm_iterations"],
                                optimizers.Params(solver="schur"), plan)
    return v["se2"].cpu().numpy()


def setup(cfg, traffic, seed, device):
    t = traffic
    dtype = getattr(torch, cfg["dtype"])
    g = manhattan.make_graph(cfg, seed)
    order = stream_order(g)
    ij, meas = g.ij[order], g.measured[order]
    n0 = t["from_pose"]
    k0 = int(np.argmax(ij.max(axis=1) >= n0))       # first edge past it
    start = _prefix_start(g, ij[:k0], meas[:k0], n0, dtype, device, t)
    eng = isam2.ISAM2(isam2.ISAM2Params(
        dtype=dtype, min_var_cap=g.start.shape[0] + 1,
        min_fac_cap=len(ij) + 8, **t["params"]), device=device)
    eng.add_variable("se2", start[0])
    eng.add_factor("prior_se2", F.make_prior_residual("se2"), ["se2"], 3,
                   [0], {"prior": g.prior},
                   NoiseModel("diag", 1.0 / g.prior_sigmas))
    for p in start[1:]:
        eng.add_variable("se2", p)
    ctx = SimpleNamespace(eng=eng, ij=ij, meas=meas, k=0, added=n0,
                          noise=NoiseModel("diag", 1.0 / g.sigmas), cg=[],
                          rb=F.make_between_residual("se2"), traffic=t)
    for k in range(k0):
        _stage(ctx, k)
    for _ in range(t["settle_updates"]):
        res = eng.update(extra_cg=t["settle_cg"])
        if res.cg_iterations < t["params"]["cg_maxiter"] + t["settle_cg"]:
            break
    ctx.k = k0
    warm = SimpleNamespace(**vars(ctx))
    warm.eng = eng.clone()
    for _ in range(t["warmup_updates"]):
        solve(warm)
    ctx.cg = []
    return ctx


def _stage(ctx, k):
    i, j = int(ctx.ij[k, 0]), int(ctx.ij[k, 1])
    if j == ctx.added:
        ctx.eng.add_variable("se2", _compose(ctx.eng.estimate_at("se2", i),
                                             ctx.meas[k]))
        ctx.added += 1
    ctx.eng.add_factor("between_se2", ctx.rb, ["se2", "se2"], 3, [i, j],
                       {"measured": ctx.meas[k]}, ctx.noise)


def solve(ctx):
    if ctx.k >= len(ctx.ij):
        raise RuntimeError("the stream has no measurement left: the window "
                           "outlasts it")
    _stage(ctx, ctx.k)
    ctx.k += 1
    res = ctx.eng.update()
    ctx.cg.append(res.cg_iterations)
    return {}, 1


def exhausted(ctx):
    """The window ends early where the stream keeps only the traced
    stretch's measurements."""
    return len(ctx.ij) - ctx.k <= ctx.traffic["trace_solves"]


def failed(answer):
    """An update that fails raises; the estimate is checked at the end."""
    return False


def final(ctx, answer):
    return {"se2": ctx.eng.calculate_estimate()["se2"],
            "k": torch.tensor(ctx.k), "n": torch.tensor(ctx.added)}


def counters(ctx):
    return {"cg_iterations": list(ctx.cg)}


def shapes(ctx):
    st = ctx.eng._state
    return {"cap": int(st.theta["se2"].shape[0]), "d": 3,
            "itemsize": st.theta["se2"].element_size()}


def spans(ctx, answer):
    return {}


def reference_inputs(cfg, seed, device, dtype, k, n):
    """The first k edges of the stream and poses 0..n-1, as the
    reference takes them, and the odometry start."""
    g = manhattan.make_graph(cfg, seed)
    order = stream_order(g)

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)
    return t(g.start[:n]), {
        "ij": t(g.ij[order][:k], torch.int64),
        "measured": t(g.measured[order][:k]), "w": t(1.0 / g.sigmas),
        "prior": t(g.prior), "w_prior": t(1.0 / g.prior_sigmas)}


def reference(cfg, traffic, seed, device, dtype=torch.float64, rnd=None,
              k=None, n=None):
    """(graph, (x, lam, err)) of the batch optimum of the stream's first k
    edges by the plain reference's LM, from the odometry start."""
    x0, g = reference_inputs(cfg, seed, device, dtype, k, n)
    return g, ref.lm_run(x0, g, traffic["reference_lambda"],
                         traffic["reference_iterations"], rnd=rnd)


def compare(answer, graph64, out, look=False):
    """The estimate's excess cost over the batch optimum, both errors
    taken by the float64 reference: err(estimate) / err(optimum) - 1."""
    x, _, err = out
    a = answer["se2"].to(x.device, torch.float64)
    e = float(ref.error(a, graph64))
    nums = {"excess_cost": e / err - 1.0}
    if look:
        nums["look_pose_rms_m"] = float(((a - x)[:, :2] ** 2).sum(1)
                                        .mean().sqrt())
    return nums


def as_answer(x, lam, err):
    return {"se2": x}


def check(cfg, traffic, seed, answers, device):
    a = answers[max(answers)]
    k, n = int(a["k"]), int(a["n"])
    graph, out = reference(cfg, traffic, seed, device, k=k, n=n)
    return compare(a, graph, out)


def calibration(path, cfg, traffic, seed, device, program, control):
    """calibrate.py's readings: `calibrate_updates` updates of the stream
    (about a window's), and the TF32 control's batch optimum of the same
    measurements, each held to the float64 optimum."""
    from portbench.reference import lie
    ctx = setup(cfg, traffic, seed, device)
    for _ in range(traffic["calibrate_updates"]):
        solve(ctx)
    ans = {k: v.detach().cpu() for k, v in final(ctx, None).items()}
    del ctx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    k, n = int(ans["k"]), int(ans["n"])
    graph, out = reference(cfg, traffic, seed, device, k=k, n=n)
    prog = compare(ans, graph, out, look=True) if program else None
    ctrl = None
    if control:
        _, c_out = reference(cfg, traffic, seed, device, torch.float32,
                             lie.tf32, k=k, n=n)
        ctrl = compare(as_answer(*c_out), graph, out, look=True)
    return prog, ctrl
