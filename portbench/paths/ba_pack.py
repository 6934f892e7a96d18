"""Bundle adjustment through sfm.ba_pack.ba_lm_run_pk.

A request is `iterations` LM tries from the seeded start at lambda
`lambda_initial`, each with `cg_maxiter` masked Schur-PCG iterations. Its
units are the tries, rejected ones included, as LevenbergMarquardtOptimizer
counts them.
"""

import time
from types import SimpleNamespace

import numpy as np
import torch

from gtsam_personal_tpu_torch.sfm import ba, ba_pack
from portbench.gen import skewed_bal
from portbench.reference import ba_pack as ref


def _inputs(cfg, seed, device, dtype):
    p = skewed_bal.make_problem(cfg, seed)
    state = ba.state_from_numpy(p.cam_poses, p.cam_cals, p.points,
                                device=device, dtype=dtype)
    obs = ba.observations_from_numpy(p.obs_cam, p.obs_point, p.obs_uv,
                                     device=device, dtype=dtype)
    return state, obs


def setup(cfg, traffic, seed, device):
    dtype = getattr(torch, cfg["dtype"])
    state, obs = _inputs(cfg, seed, device, dtype)
    C, P = state.cam_poses.shape[0], state.points.shape[0]
    pl = ba_pack.make_pack_layout(obs, C, P)
    ctx = SimpleNamespace(state=state, obs=obs, pl=pl, traffic=traffic,
                          err0=ba_pack.ba_error_pk(state, obs, pl))
    solve(ctx)                     # warm-up: every shape of the request
    return ctx


def solve(ctx):
    t = ctx.traffic
    st, lam, err = ba_pack.ba_lm_run_pk(
        ctx.state, ctx.obs, ctx.pl, t["lambda_initial"], ctx.err0,
        n_iters=t["iterations"], cg_maxiter=t["cg_maxiter"])
    return ({"poses": st.cam_poses, "cals": st.cam_cals,
             "points": st.points, "lam": lam, "err": err},
            t["iterations"])


def failed(answer):
    return not bool(torch.isfinite(answer["err"]))


def shapes(ctx):
    return {"P": ctx.pl.P, "C": ctx.pl.C, "M": ctx.pl.M,
            "itemsize": ctx.state.points.element_size()}


def spans(ctx, answer):
    """ms of `linearize_ba_pk` at the state the window's last solve left,
    by CUDA events around each call."""
    st = ba.BAState(answer["poses"], answer["cals"], answer["points"])
    ms = []
    cuda = st.points.is_cuda
    for _ in range(ctx.traffic["span_calls"]):
        if cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
        t0 = time.perf_counter()
        ba_pack.linearize_ba_pk(st, ctx.obs, ctx.pl)
        if cuda:
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        else:
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"ba_linearize_ms": ms}


def reference_inputs(cfg, seed, device, dtype):
    """The same inputs, as the reference's tuples."""
    p = skewed_bal.make_problem(cfg, seed)

    def t(a, dt=dtype):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)
    return ((t(p.cam_poses), t(p.cam_cals), t(p.points)),
            (t(p.obs_cam, torch.int64), t(p.obs_point, torch.int64),
             t(p.obs_uv)))


def compare(answer, inputs, out, look=False):
    """The numbers compared: how far the float64 reference's error of the
    answer's state lies above that of the reference's own outcome, as a
    share of the latter (below it reads negative, and passes), and
    lambda's relative gap. `look` adds the state's gap as a share of the
    reference's move (2-norms over each array, the worst array) and the
    widest entry's gap of each array as a share of its largest move. The
    state is not compared: where one try's acceptance turns on float32's
    resolution, sound runs take the other branch and their states end
    about as far from the reference's as the TF32 control's."""
    start, obs = inputs
    (poses, cals, points), lam, err = out
    state = tuple(answer[k].to(points.device, torch.float64)
                  for k in ("poses", "cals", "points"))
    nums = {"error_excess": (float(ref.error(state, obs)) - err) / abs(err)}
    if "lam" in answer:
        nums["lambda_gap"] = abs(float(answer["lam"]) - lam) / abs(lam)
    if look:
        gap = 0.0
        for key, a, r, s in zip(("poses", "cals", "points"), state,
                                (poses, cals, points), start):
            gap = max(gap, float((a - r).norm() / (r - s).norm()))
            nums[f"look_widest_{key}"] = float(
                (a - r).abs().max() / (r - s).abs().max())
        nums["look_state_gap"] = gap
    return nums


def reference(cfg, traffic, seed, device, dtype=torch.float64, rnd=None):
    """((start, observations), (state, lam, err)) of the plain
    reference."""
    state, obs = reference_inputs(cfg, seed, device, dtype)
    out = ref.lm_run(state, obs, traffic["lambda_initial"],
                     traffic["iterations"], traffic["cg_maxiter"], rnd=rnd)
    return (state, obs), out



def as_answer(state, lam, err):
    """A reference's outcome in the form of the program's answer."""
    return {"poses": state[0], "cals": state[1], "points": state[2],
            "lam": torch.tensor(lam), "err": torch.tensor(err)}
