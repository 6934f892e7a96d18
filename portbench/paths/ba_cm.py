"""Bundle adjustment through the camera-major engine, sfm.ba.optimize_ba.

A request is one `optimize_ba` run of at most `iterations` iterations from
the seeded start at lambda `lambda_initial`, PCG to 1e-6 in at most
`cg_maxiter` iterations a try. Its units are the tries, counted by the
engine's probe at each trial error.
"""

from types import SimpleNamespace

import torch

from gtsam_personal_tpu_torch.sfm import ba
from portbench.paths import ba_pack as pack
from portbench.reference import ba_cm as ref

failed = pack.failed
shapes = pack.shapes


def setup(cfg, traffic, seed, device):
    dtype = getattr(torch, cfg["dtype"])
    state, obs = pack._inputs(cfg, seed, device, dtype)
    C, P = state.cam_poses.shape[0], state.points.shape[0]
    ctx = SimpleNamespace(state=state, obs=obs, traffic=traffic,
                          pl=ba.make_layout(obs, C, P))
    solve(ctx)                     # warm-up: every shape of the request
    return ctx


def _run(ctx, probe):
    t = ctx.traffic
    return ba.optimize_ba(ctx.state, ctx.obs, ctx.pl,
                          max_iterations=t["iterations"],
                          lambda_initial=t["lambda_initial"],
                          cg_maxiter=t["cg_maxiter"], probe=probe)


def solve(ctx):
    tries = [0]

    def probe(label, **kw):
        if label == "error":
            tries[0] += 1
    st, err, _ = _run(ctx, probe)
    dt = st.points.dtype
    return ({"poses": st.cam_poses, "cals": st.cam_cals,
             "points": st.points, "err": torch.tensor(err, dtype=dt),
             "tries": torch.tensor(tries[0])}, tries[0])


def spans(ctx, answer):
    """One more request with a probe that records CUDA events (host clock
    on the CPU) at "precond" and "pcg", and the PCG iterations of each
    try."""
    import time
    marks, iters = [], []
    cuda = ctx.state.points.is_cuda

    def probe(label, **kw):
        if label in ("precond", "pcg"):
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
            else:
                e = time.perf_counter()
            marks.append(e)
        if label == "pcg":
            iters.append(kw["iterations"])
    _run(ctx, probe)
    if cuda:
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(marks[::2], marks[1::2])]
    return {"ba_pcg_ms": ms, "ba_pcg_iters": [int(i) for i in iters]}


def reference(cfg, traffic, seed, device, dtype=torch.float64, rnd=None):
    """((start, observations), (state, lam, err, tries)) of the plain
    reference."""
    state, obs = pack.reference_inputs(cfg, seed, device, dtype)
    return (state, obs), ref.optimize(state, obs, traffic["lambda_initial"],
                                      traffic["iterations"],
                                      traffic["cg_maxiter"], rnd=rnd)


def compare(answer, inputs, out, look=False):
    """ba_pack's `error_excess`: how far the float64 reference's error of
    the answer's state lies above that of its own outcome. `look` adds
    ba_pack's state gaps and the tries' difference, which are not
    compared: a hundred CG iterations in float32 drift from float64's, so
    sound runs' states lie 2-65% of the move apart and their tries up to
    16 apart."""
    state, lam, err, tries = out
    nums = pack.compare(answer, inputs, (state, lam, err), look)
    if not look:
        return {"error_excess": nums["error_excess"]}
    nums["look_tries_gap"] = float(abs(int(answer["tries"]) - tries))
    return nums


def as_answer(state, lam, err, tries):
    return {"poses": state[0], "cals": state[1], "points": state[2],
            "err": torch.tensor(err), "tries": torch.tensor(tries)}
