"""Batch pose-graph SLAM through nonlinear.optimizers.lm_run with the
partitioned Schur solver.

Set-up builds the graph from the stand-in's arrays (core.graph.
graph_from_numpy), the odometry start and a schur.make_plan plan of parts of
at most `max_part_size` poses. A request is `iterations` LM tries of
`lm_run` from the start at lambda `lambda_initial`; its units are the tries.
"""

import time
from types import SimpleNamespace

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import graph_from_numpy
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.linear import schur
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam.factors import residual_by_name
from portbench.gen import manhattan
from portbench.reference import pose_schur as ref


def batches(g, ij, meas, K):
    """graph_from_numpy's batches of a stand-in's prior and K edges."""
    return [
        {"name": "prior_se2", "groups": ["se2"], "rdim": 3,
         "idx": np.zeros((1, 1), dtype=np.int64),
         "meas": {"prior": g.prior[None]},
         "noise": {"kind": "diag", "data": (1.0 / g.prior_sigmas)[None]}},
        {"name": "between_se2", "groups": ["se2", "se2"], "rdim": 3,
         "idx": ij, "meas": {"measured": meas},
         "noise": {"kind": "diag", "data": np.tile(1.0 / g.sigmas, (K, 1))}}]


def setup(cfg, traffic, seed, device):
    dtype = getattr(torch, cfg["dtype"])
    g = manhattan.make_graph(cfg, seed)
    graph = graph_from_numpy(batches(g, g.ij, g.measured, len(g.ij)),
                             residual_by_name, device=device, dtype=dtype)
    values = values_from_numpy({"se2": g.start}, device=device, dtype=dtype)
    plan = schur.make_plan(graph, {"se2": g.start.shape[0]},
                           max_part_size=traffic["max_part_size"])
    ctx = SimpleNamespace(graph=graph, values=values, plan=plan,
                          traffic=traffic,
                          params=optimizers.Params(solver="schur"),
                          err0=optimizers.graph_error(graph, values))
    solve(ctx)                     # warm-up: every shape of the request
    return ctx


def solve(ctx):
    t = ctx.traffic
    v, lam, err = optimizers.lm_run(ctx.graph, ctx.values,
                                    t["lambda_initial"], ctx.err0,
                                    t["iterations"], ctx.params, ctx.plan)
    return {"se2": v["se2"], "lam": lam, "err": err}, t["iterations"]


def failed(answer):
    return not bool(torch.isfinite(answer["err"]))


def shapes(ctx):
    return {"N": ctx.values["se2"].shape[0], "K": ctx.graph.num_factors,
            "itemsize": ctx.values["se2"].element_size()}


def _timed(fn, n, cuda):
    ms = []
    for _ in range(n):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


def spans(ctx, answer):
    """ms of `linearize` at the values the window's last solve left, and of
    `solve_partitioned` on that linearization at its lambda (host clock
    between synchronizes)."""
    values = ctx.values.__class__({"se2": answer["se2"]})
    cuda = answer["se2"].is_cuda
    n = ctx.traffic["span_calls"]
    lin_ms, lin = _timed(lambda: linearize(ctx.graph, values), n, cuda)
    schur_ms, _ = _timed(lambda: schur.solve_partitioned(
        lin, ctx.plan, answer["lam"]), n, cuda)
    return {"pose_linearize_ms": lin_ms, "pose_schur_ms": schur_ms}


def reference_inputs(cfg, seed, device, dtype):
    g = manhattan.make_graph(cfg, seed)

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)
    return t(g.start), {"ij": t(g.ij, torch.int64), "measured": t(g.measured),
                        "w": t(1.0 / g.sigmas), "prior": t(g.prior),
                        "w_prior": t(1.0 / g.prior_sigmas)}


def reference(cfg, traffic, seed, device, dtype=torch.float64, rnd=None):
    """((start, graph), (x, lam, err)) of the plain reference."""
    x0, g = reference_inputs(cfg, seed, device, dtype)
    return (x0, g), ref.lm_run(x0, g, traffic["lambda_initial"],
                               traffic["iterations"], rnd=rnd)


def _relative(p):
    """Log(p_i^-1 p_i+1) of consecutive poses: the local shape of the
    trajectory, blind to the drift that the loops leave weakly held."""
    return ref._local(p[:-1], p[1:])


def compare(answer, inputs, out, look=False):
    """The gap of the answer's relative poses of consecutive poses from the
    reference's, as a share of the reference's change to them (2-norms over
    all of them). `look` adds the relative gap between the float64
    reference's error of the answer's poses and of its own outcome, the
    poses' gap as a share of the reference's move and the widest pose's
    as a share of the largest move. These are not compared: the tries stop
    short of the optimum, where float32's iterates wander along the loops'
    weak directions as far as the TF32 control's do, and the error of a
    state off the optimum differs by as much. Nor is lambda: a try's
    acceptance can turn on an error change below float32's resolution."""
    start, g = inputs
    x, lam, err = out
    a = answer["se2"].to(x.device, torch.float64)
    nums = {"local_gap": float((_relative(a) - _relative(x)).norm()
                               / (_relative(x) - _relative(start)).norm())}
    if look:
        nums["look_error_gap"] = abs(float(ref.error(a, g)) - err) / abs(err)
        nums["look_pose_gap"] = float((a - x).norm() / (x - start).norm())
        nums["look_widest_pose"] = float((a - x).abs().max()
                                         / (x - start).abs().max())
    return nums



def as_answer(x, lam, err):
    """A reference's outcome in the form of the program's answer."""
    return {"se2": x, "lam": torch.tensor(lam), "err": torch.tensor(err)}
