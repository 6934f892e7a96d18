"""Inverse kinematics of a planar 3R arm as factor-graph optimization.

    python -m gtsam_personal_tpu_torch.tools.inverse_kinematics
        [--device cuda]

JAX counterpart: examples/inverse_kinematics.py (the reference's
examples/InverseKinematicsExampleExpressions.cpp): the end-effector pose
is the product of exponentials
  forward(q) = Exp(q1 xi1) Exp(q2 xi2) Exp(q3 xi3) sXt0
with screw axes xi1 = (0, 0, 1), xi2 = (L1, 0, 1), xi3 = (L1 + L2, 0, 1)
and rest pose sXt0 = Pose2(0, L1 + L2 + L3, pi/2); one residual function
differentiated by torch takes the place of the reference's Expression
tree. Prints IK OK when the end effector reaches the target to 1e-8. The
device is the card unless `--device cpu` asks for the CPU.
"""

import argparse

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.geometry import se2
from gtsam_personal_tpu_torch.nonlinear import optimizers

L1, L2, L3 = 3.5, 3.5, 2.5
REST = np.array([0.0, L1 + L2 + L3, np.pi / 2])         # sXt0
SCREWS = np.array([[0.0, 0.0, 1.0],
                   [L1, 0.0, 1.0],
                   [L1 + L2, 0.0, 1.0]])
DESIRED = np.array([3.0, 2.0, 0.0])                     # Pose2(3, 2, 0)


def forward(q):
    """End-effector pose [3] of the joint angles q [3]."""
    xis = torch.as_tensor(SCREWS, dtype=q.dtype, device=q.device)
    pose = se2.expmap(q[0:1] * xis[0])
    pose = se2.compose(pose, se2.expmap(q[1:2] * xis[1]))
    pose = se2.compose(pose, se2.expmap(q[2:3] * xis[2]))
    return se2.compose(pose, torch.as_tensor(REST, dtype=q.dtype,
                                             device=q.device))


def ik_residual(xs, meas):
    (q,) = xs
    return se2.local(meas["desired"], forward(q))


def run(device="cuda", say=print):
    """Returns a dict: 'q' (the joint angles), 'reached' (the pose), 'err'
    (max abs of local(desired, reached)), 'ok', 'result'."""
    dev = config.device(device)
    b = GraphBuilder()
    b.add("ik", ik_residual, ("r3",), 3, [0], {"desired": DESIRED},
          {"kind": "diag", "data": np.full(3, 100.0)})
    graph = b.build(device=dev, dtype=torch.float64)
    # the reference's initial estimate: a slightly bent arm
    init = values_from_numpy({"r3": np.array([[0.1, 0.2, 0.3]])},
                             device=dev, dtype=torch.float64)
    res = optimizers.optimize_lm(graph, init,
                                 optimizers.Params(max_iterations=50))
    q = res.values["r3"][0]
    reached = forward(q)
    qn, rn = q.cpu().numpy(), reached.cpu().numpy()
    say(f"joint angles (deg): {np.round(np.rad2deg(qn), 2).tolist()}")
    say(f"end effector: ({rn[0]:.6f}, {rn[1]:.6f}, {rn[2]:.6f})  target "
        f"{DESIRED.tolist()}")
    err = float(se2.local(torch.as_tensor(DESIRED, device=dev), reached)
                .abs().max())
    ok = err < 1e-8
    say("IK OK" if ok else "IK FAIL")
    return {"q": qn, "reached": rn, "err": err, "ok": ok, "result": res}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return 0 if run(ap.parse_args(argv).device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
