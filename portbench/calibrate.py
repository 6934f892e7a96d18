"""Readings that the limits of limits/<workload>.json are set from: for
each seed, one request of the cell's timed path at the cell's size, held
to the float64 reference, and the lower-precision control (the same
reference in float32 with every product's operands rounded to TF32) held to
it too.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3]

Prints one JSON line per reading and a summary: the largest program reading
and the smallest control reading of each number. Not run by the benchmark's
own runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _calibration(path, cfg, traffic, seed, device, program, control):
    """(program's numbers, control's numbers) of one seed, each None where
    not asked for: one request of the timed path, and the reference in
    float32 with TF32 products, each held to the float64 reference."""
    import torch
    from portbench.reference import lie
    inputs, ref = path.reference(cfg, traffic, seed, device)
    prog = ctrl = None
    if program:
        ctx = path.setup(cfg, traffic, seed, device)
        ans, _ = path.solve(ctx)
        ans = {k: v.detach().cpu() for k, v in ans.items()}
        del ctx
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        prog = path.compare(ans, inputs, ref, look=True)
    if control:
        _, c_out = path.reference(cfg, traffic, seed, device, torch.float32,
                                  lie.tf32)
        ctrl = path.compare(path.as_answer(*c_out), inputs, ref, look=True)
    return prog, ctrl


def readings(workload, seeds, control_seeds, device="cuda", cfg_override=None,
             say=print, traffic_override=None):
    from portbench import harness
    man = harness.manifest()
    wl = harness.find(man["workloads"], workload, "workload")
    conf = harness.find(man["configs"], wl["config"], "config")
    cfg = harness.load_json(ROOT / conf["file"])
    cfg.update(cfg_override or {})
    traffic = harness.load_json(harness.HERE / "traffic"
                                / f"{wl['traffic']}.json")
    traffic.update(traffic_override or {})
    path = harness.path_module(traffic["path"])
    out = {"program": {}, "control": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        reading = getattr(path, "calibration", None) or _calibration
        prog, ctrl = reading(path, cfg, traffic, seed, device,
                             seed in seeds, seed in control_seeds)
        for side, nums in (("program", prog), ("control", ctrl)):
            if nums is not None:
                out[side][seed] = nums
                say(json.dumps({"seed": seed, "side": side, **nums}))
        say(f"# seed {seed}: {time.perf_counter() - t0:.1f} s")
    summary = {}
    for side, pick in (("program", max), ("control", min)):
        vals = out[side].values()
        if vals:
            summary[side] = {k: pick(v[k] for v in vals)
                             for k in next(iter(vals))}
    say(json.dumps({"summary": summary}))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-dtype", help="run the program in this dtype "
                    "instead of the configuration's (a witness)")
    args = ap.parse_args()
    readings(args.workload, args.seeds, args.control_seeds,
             cfg_override={"dtype": args.program_dtype}
             if args.program_dtype else None)


if __name__ == "__main__":
    main()
