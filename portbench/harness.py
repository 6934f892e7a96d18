"""The general harness: finds a cell's configuration, traffic, path driver,
limits and metric readers by the names in BENCHMARK.json, runs set-up, the
measured window, the traced stretch and the check against the plain
reference, and prints the result line.

A path driver (paths/<path>.py) provides
  setup(cfg, traffic, seed, device) -> ctx    inputs, program state, warm-up
  solve(ctx) -> (answer, units)               one request of the closed loop
  failed(answer) -> bool                      a request that gave no result
  spans(ctx, answer) -> {name: [ms, ...]}     per-layer timings (traced run)
  shapes(ctx) -> dict                         sizes the roofline readers use
  reference(cfg, traffic, seed, device) -> (inputs, outcome)
                                              the float64 plain reference
  compare(answer, inputs, outcome) -> {name: value}
                                              the numbers held to limits
and may provide
  check(cfg, traffic, seed, answers, device) -> {name: value}
                                              in place of the worst of
                                              `compare` over the answers
  final(ctx, answer) -> answer                what the window's last request
                                              left, to be checked
  counters(ctx) -> dict                       counts the window gathered
  exhausted(ctx) -> bool                      a finite stream has no
                                              request left for the window
The numbers are held to limits/<workload>.json. A metric reader
(metrics/<name>.py) has read(rec) -> float or None.
"""

import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "gtsam_personal_tpu")


def load_json(path):
    return json.loads(Path(path).read_text())


def manifest():
    return load_json(ROOT / "BENCHMARK.json")


def find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(man, workload, trace):
    """The metric entries that this cell reports in this mode."""
    return [m for m in man["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def load_reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def path_module(name):
    return importlib.import_module(f"portbench.paths.{name}")


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def check(path, cfg, traffic, seed, answers, device):
    """The worst of each compared number over the checked answers, against
    one run of the reference (every request solves the same problem), or
    the path's own check."""
    if hasattr(path, "check"):
        return path.check(cfg, traffic, seed, answers, device)
    inputs, out = path.reference(cfg, traffic, seed, device)
    worst = {}
    for a in answers.values():
        for k, v in path.compare(a, inputs, out).items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def sample_indices(seed, traffic):
    """The solves whose answers are checked: `samples` drawn from the seed
    among the first `min_solves`, and the window's last."""
    rng = np.random.default_rng(seed)
    return set(rng.choice(traffic["min_solves"], size=traffic["samples"],
                          replace=False).tolist())


def window(path, ctx, seconds, sync, keep):
    """Closed loop: solve after solve until `seconds` have passed at the end
    of one, or a finite stream runs out. Returns (solves, units, failed,
    window seconds, kept answers by index, last answer, seconds of each
    solve)."""
    exhausted = getattr(path, "exhausted", lambda ctx: False)
    kept, n, units, bad, each = {}, 0, 0, 0, []
    sync()
    t0 = t1 = time.perf_counter()
    while True:
        ans, u = path.solve(ctx)
        bad += bool(path.failed(ans))
        if n in keep:
            kept[n] = ans
        n += 1
        units += u
        sync()
        t2 = time.perf_counter()
        each.append(t2 - t1)
        t1 = t2
        if t2 - t0 >= seconds or exhausted(ctx):
            break
    final = getattr(path, "final", None)
    kept[n - 1] = final(ctx, ans) if final else ans
    return n, units, bad, t1 - t0, kept, ans, each


def run(workload, seed, seconds, trace, process_start, device="cuda",
        man=None, cfg_override=None, traffic_override=None):
    """One run of a cell; returns (result dict, check lines). `device` and
    the overrides exist for the CPU tests; the command passes none."""
    import torch
    from portbench import trace as tr

    man = man or manifest()
    wl = find(man["workloads"], workload, "workload")
    conf = find(man["configs"], wl["config"], "config")
    cfg = load_json(ROOT / conf["file"])
    cfg.update(cfg_override or {})
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    traffic.update(traffic_override or {})
    limits = load_json(HERE / "limits" / f"{workload}.json")
    path = path_module(traffic["path"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    ctx = path.setup(cfg, traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - process_start
    n, units, bad, window_s, kept, last, each = window(
        path, ctx, seconds, sync, sample_indices(seed, traffic))
    counters = getattr(path, "counters", None)
    rec = {"setup_s": setup_s, "window_s": window_s, "units": units,
           "solves": n, "solve_s": each, "workload": workload, "cfg": cfg,
           "traffic": traffic, "shapes": path.shapes(ctx),
           "counters": counters(ctx) if counters else {}}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": wl["chips"]}
    breakdown = None
    if trace:
        _, t = tr.profile(lambda: [path.solve(ctx) for _ in
                                   range(traffic["trace_solves"])], device)
        rec["trace"] = t
        rec["spans"] = path.spans(ctx, last)
        device_info.update(busy_s=t.busy_s, window_s=t.window_s,
                           power_limit=power_limit() if cuda else "none")
        breakdown = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                        if cuda else 0)
    metrics = {}
    for m in cell_metrics(man, workload, trace):
        v = load_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    answers = {k: {name: x.detach().cpu() for name, x in a.items()}
               for k, a in kept.items()}
    del ctx, kept, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check(path, cfg, traffic, seed, answers, device)
    checks = {k: {"value": float(v), "limit": limits[k]}
              for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and set(checks) == set(limits) and bad == 0
    result = {"correct": bool(correct), "attempted": n, "failed": bad,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"check {k}: {c['value']:.6e} limit {c['limit']:.6e}"
             for k, c in checks.items()]
    return result, lines


def main(workload, seed, seconds, trace, process_start):
    import torch
    man = manifest()
    wl = find(man["workloads"], workload, "workload")
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"the cell asks for {wl['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, lines = run(workload, seed, seconds, trace, process_start,
                        man=man)
    found = banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
