"""The ISAM2 stream runner, and where an update's time goes on one CUDA
card.

    python -m gtsam_personal_tpu_torch.tools.profile_isam2 [--out FILE]

JAX counterpart: examples/isam2_city10000.py (the stream) and
tools/profile_isam2_chain.py (the split). The stream is the 10000-pose
Manhattan world of slam/manhattan.py (the real city10000.g2o is not in the
repository): `stream_data` takes idx, measured and the noise data out of the
graph's between batch, as the example takes them out of the g2o graph, and
orders the factors by their later pose, odometry before closures.
`run_stream` drives the engine as the example does, with its defaults (the
constants below, which chip_smoke.py phase 10 imports).

As a program it streams at one update per 10 measurements up to pose
PROFILE_FROM, then with an update after every measurement, and prints:
  - the card's name and power limit;
  - ms per update of that per-measurement window (host clock; an update ends
    in a host read, so the device has finished);
  - the split of the window's updates into relinearization, preconditioner
    rebuild, PCG and the rest, each timed between synchronizes (which this
    mode adds), with relinearized rows and CG iterations;
  - from one `torch.profiler` pass over PROFILE_UPDATES updates: the
    device's busy share, the device events per update and device time by
    operator; the chain_factorize kernel is the row "launched outside any
    operator".
With `--out FILE` the same text is also written to that file.
"""

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import isam2
from gtsam_personal_tpu_torch.ops.chain import chain_factorize
from gtsam_personal_tpu_torch.slam import factors as F, manhattan
from gtsam_personal_tpu_torch.tools.profile_pose_graph import device_ms

# the full-size stream, here and in chip_smoke.py phase 10: the defaults of
# examples/isam2_city10000.py
ISAM_N = 10000
ISAM_PARAMS = dict(relinearize_threshold=0.01, cg_maxiter=40, cg_tol=1e-3,
                   relin_chunk=256, precond="chain:se2")
ISAM_POLISH = 6             # updates after the last measurement
ISAM_UPDATE_EVERY = 10      # measurements per update before the switch pose
PROFILE_FROM = 9000         # this program: per-measurement updates from here
PROFILE_UPDATES = 40        # updates under the profiler
LINES = []


def say(text=""):
    print(text, flush=True)
    LINES.append(text)


def _compose(a, b):
    """SE(2) a * b on (x, y, theta) triples, on the host."""
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     a[2] + b[2]])


def stream_data(graph):
    """{prior, prior_noise, ij [K, 2], measured [K, 3], noise_kind,
    noise [K, ...]} as numpy arrays, from the `prior_se2` and `between_se2`
    batches of a pose graph; the between factors ordered by their later
    pose, and at one pose odometry (j = i + 1) before closures."""
    by_name = {b.name: b for b in graph.batches}
    prior, between = by_name["prior_se2"], by_name["between_se2"]
    ij = between.idx.cpu().numpy()
    order = np.lexsort((ij[:, 1] - ij[:, 0] != 1, ij.max(axis=1)))
    return {"prior": prior.meas["prior"][0].cpu().numpy(),
            "prior_noise": (prior.noise.kind,
                            prior.noise.data[0].cpu().numpy()),
            "ij": ij[order],
            "measured": between.meas["measured"].cpu().numpy()[order],
            "noise_kind": between.noise.kind,
            "noise": between.noise.data.cpu().numpy()[order]}


def make_engine(data, *, device, dtype, **params):
    """An engine sized for the whole stream (ISAM_PARAMS, with `params` over
    them), with the prior on pose 0 in and one update made."""
    n = int(data["ij"].max()) + 1
    isam = isam2.ISAM2(isam2.ISAM2Params(
        dtype=dtype, min_var_cap=n + 1, min_fac_cap=len(data["ij"]) + 8,
        **dict(ISAM_PARAMS, **params)), device=device)
    isam.add_variable("se2", data["prior"])
    kind, w = data["prior_noise"]
    isam.add_factor("prior_se2", F.make_prior_residual("se2"), ["se2"], 3,
                    [0], {"prior": data["prior"]}, NoiseModel(kind, w))
    isam.update()
    return isam


def run_stream(isam, data, start=0, stop=None, update_every=1,
               switch_pose=None):
    """Feed between factors start..stop (all by default) to the engine. A
    factor whose later pose is new adds that pose first, initialised from
    `estimate_at` of the earlier pose composed with the measurement. Updates
    come every `update_every` measurements until `switch_pose` poses exist,
    and after every measurement from there on.

    Returns one record per update: (poses, seconds, relinearized rows, CG
    iterations), the seconds being the host clock since the previous update
    ended (staging included)."""
    ij, meas, noise = data["ij"], data["measured"], data["noise"]
    rb = F.make_between_residual("se2")
    stop = len(ij) if stop is None else stop
    added = isam._nvar["se2"]
    records = []
    t0 = time.perf_counter()
    for k in range(start, stop):
        i, j = int(ij[k, 0]), int(ij[k, 1])
        if j == added:
            isam.add_variable("se2", _compose(isam.estimate_at("se2", i),
                                              meas[k]))
            added += 1
        isam.add_factor("between_se2", rb, ["se2", "se2"], 3, [i, j],
                        {"measured": meas[k]},
                        NoiseModel(data["noise_kind"], noise[k]))
        every = (1 if switch_pose is not None and added >= switch_pose
                 else update_every)
        if k % every == 0:
            res = isam.update()
            t1 = time.perf_counter()
            records.append((added, t1 - t0, res.relinearized_rows,
                            res.cg_iterations))
            t0 = t1
    return records


def polish(isam, n=ISAM_POLISH):
    """`n` more updates of the same shape (the example's final polish)."""
    return [isam.update() for _ in range(n)]


def summarize(records):
    """(updates, ms per update, median and max relinearized rows, median and
    max CG iterations) of a list of update records."""
    sec = np.array([r[1] for r in records])
    rows = np.array([r[2] for r in records])
    its = np.array([r[3] for r in records])
    return (len(records), 1e3 * sec.mean(), float(np.median(rows)),
            int(rows.max()), float(np.median(its)), int(its.max()))


class _Split:
    """Times the pieces of `_isam2_update` between synchronizes, by wrapping
    the module's own functions for the length of a `with` block."""

    NAMES = ("linearize_batch", "_build_precond_cache", "_pcg_counting")

    def __init__(self):
        self.ms = {name: 0.0 for name in self.NAMES}
        self.calls = {name: 0 for name in self.NAMES}

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            self.calls[name] += 1
            return out
        return timed

    def __enter__(self):
        self._saved = {name: getattr(isam2, name) for name in self.NAMES}
        for name, fn in self._saved.items():
            setattr(isam2, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(isam2, name, fn)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()
    dev = config.device("cuda")
    dtype = torch.float32
    say(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    graph, _, _ = manhattan.make_manhattan(ISAM_N, seed=42, device=dev,
                                           dtype=dtype)
    data = stream_data(graph)
    ij = data["ij"]
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {ISAM_N} "
        f"poses, {len(ij)} between factors, float32, {ISAM_PARAMS}")
    isam = make_engine(data, device=dev, dtype=dtype)
    first = int(np.argmax(ij.max(axis=1) >= PROFILE_FROM))
    t0 = time.perf_counter()
    recs = run_stream(isam, data, 0, first, ISAM_UPDATE_EVERY)
    say(f"poses 1..{PROFILE_FROM}: {len(recs)} updates, one per "
        f"{ISAM_UPDATE_EVERY} measurements, in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({summarize(recs)[1]:.2f} ms per update)")

    # a window of plain per-measurement updates
    k = first
    recs = run_stream(isam, data, k, k + 300)
    k += 300
    n, ms, rmed, rmax, cmed, cmax = summarize(recs)
    say(f"{n} updates, one per measurement: {ms:.3f} ms per update; "
        f"relinearized rows median {rmed:g} max {rmax}; CG iterations "
        f"median {cmed:g} max {cmax}; state capacity "
        f"{isam._cap_n['se2']} poses, "
        f"{max(h['cap'] for h in isam._hosts.values())} factor rows")

    # the split, with synchronizes around each piece
    launches0 = chain_factorize.launches
    with _Split() as split:
        recs = run_stream(isam, data, k, k + 300)
    k += 300
    n, ms, rmed, rmax, cmed, cmax = summarize(recs)
    rest = ms - sum(split.ms.values()) / n
    say(f"{n} updates with a synchronize around each piece: {ms:.3f} ms per "
        f"update; relinearized rows median {rmed:g} max {rmax}; CG "
        f"iterations median {cmed:g} max {cmax}, mean "
        f"{np.mean([r[3] for r in recs]):.2f}; chain_factorize launches "
        f"{chain_factorize.launches - launches0}")
    say("| Piece | ms per update | calls per update |")
    say("|---|---|---|")
    for name, label in (("linearize_batch", "relinearize (vmap + jacfwd)"),
                        ("_build_precond_cache",
                         "preconditioner rebuild (harvest, chain_factorize "
                         "kernel, scan matrices)"),
                        ("_pcg_counting", "PCG (matvec, chain_apply)")):
        say(f"| {label} | {split.ms[name] / n:.3f} | "
            f"{split.calls[name] / n:.2f} |")
    say(f"| the rest (staging, estimate_at, retract, stale rows, gradient) "
        f"| {rest:.3f} | |")

    # device time by operator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recs = run_stream(isam, data, k, k + PROFILE_UPDATES)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total, events, rows = device_ms(prof)
    n = len(recs)
    say(f"profiled window of {n} updates (profiler on): wall "
        f"{wall / n:.2f} ms per update, device time {total / n:.3f} ms per "
        f"update, busy share {total / wall:.3f}, {events / n:.0f} device "
        f"events per update, mean CG iterations "
        f"{np.mean([r[3] for r in recs]):.2f}")
    say("| Operator | Device ms per update | Share | Calls per update |")
    say("|---|---|---|---|")
    for key, ms, count in rows[:12]:
        say(f"| `{key}` | {ms / n:.4f} | {100 * ms / total:.1f}% | "
            f"{count / n:.1f} |")
    rest = total - sum(r[1] for r in rows)
    say(f"| launched outside any operator (the chain_factorize kernel) | "
        f"{rest / n:.4f} | {100 * rest / total:.1f}% | |")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(LINES) + "\n")


if __name__ == "__main__":
    main()
