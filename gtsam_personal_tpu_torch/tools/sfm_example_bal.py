"""Bundle adjustment on a BAL file.

    python -m gtsam_personal_tpu_torch.tools.sfm_example_bal [FILE]
        [--iters 30] [--engine pack|cm] [--robust huber] [--device cuda]

JAX counterpart: examples/sfm_example_bal.py (the reference's
examples/SFMExample_bal.cpp), with the same flags and printed lines: load
a BAL problem (or a Bundler .out file), run LM, report the reprojection
statistics. `--engine pack` runs sfm/ba_pack.py:optimize_ba_pk (with
`--robust`), `--engine cm` sfm/ba.py:optimize_ba, the camera-major engine.
With no FILE the reference's example data is looked up
(slam/dataset.py:find_example_data: dubrovnik-3-7-pre.txt); any file that
sfm/bal.py:write_bal writes works. The device is the card unless
`--device cpu` asks for the CPU; the problem is float64, as the JAX
example's is under x64.

`run` does the work, prints through `say` and returns what it measured.
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.sfm import ba, ba_pack, bal
from gtsam_personal_tpu_torch.slam.dataset import find_example_data


def run(path=None, iters=30, engine="pack", robust="none", device="cuda",
        dtype=torch.float64, say=print):
    """Returns a dict: 'initial' and 'final' error, 'iterations',
    'seconds'."""
    dev = config.device(device)
    if path is None:
        path = find_example_data("dubrovnik-3-7-pre.txt")
    prob = (bal.load_bundler(path) if path.endswith(".out")
            else bal.load_bal(path))
    say(f"cameras={prob.num_cameras} points={prob.num_points} "
        f"observations={prob.num_observations}")
    state, obs = ba.state_from_bal(prob, device=dev, dtype=dtype)
    e0 = float(ba.ba_error(state, obs))
    say("initial: error %.6g, rms %.3f px" % (
        e0, np.sqrt(2 * e0 / prob.num_observations)))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    if engine == "pack":
        _, err, its = ba_pack.optimize_ba_pk(
            state, obs, max_iterations=iters, robust=robust, verbose=True)
    else:
        layout = ba.make_layout(obs, prob.num_cameras, prob.num_points)
        _, err, its = ba.optimize_ba(state, obs, layout,
                                     max_iterations=iters, verbose=True)
    dt = time.time() - t0
    say("final: error %.6g, rms %.3f px, %d iterations in %.2fs "
        "(%.2f it/s)" % (err, np.sqrt(2 * err / prob.num_observations),
                         its, dt, its / max(dt, 1e-9)))
    return {"initial": e0, "final": err, "iterations": its, "seconds": dt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--engine", choices=["pack", "cm"], default="pack",
                    help="pack = ba_pack.optimize_ba_pk; cm = the "
                         "camera-major engine, ba.optimize_ba")
    ap.add_argument("--robust", default="none",
                    help="optional m-estimator for the pack engine "
                         "(huber, cauchy, ...)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.path, a.iters, a.engine, a.robust, a.device)


if __name__ == "__main__":
    main()
