"""Time the chain and preintegration kernels on the card, each held
against its plain version first, beside its bound.

    python -m gtsam_personal_tpu_torch.tools.time_kernels [--out FILE]
        [--kernels chain,tangent,rotation]

Launches (the shapes of chip_smoke.py's phases 8, 14 and 17):
`chain_factorize` at d = 3, 4 and 6 in float32 at capacity 16384 and at
d = 15 in float64 at capacity 512, on chip_smoke's seeded block-tridiagonal
SPD chains; `preint_tangent` in float64 for one segment of 200 samples and
for 2000 segments of 200, on phase 14's inputs; `preint_rotation` in both
modes (manifold, AHRS) on the same inputs, in float64 for one segment and
for 2000, and in float32 for 2000. Each time (`ms`) is the mean of a run
of launches between two CUDA events, after a warm-up (chip_smoke's
`_time_ms`); a preintegration kernel's record has the device's time beside
it (`device_ms`), from a CUDA graph of 20 launches (chip_smoke's
`_graph_ms`: a kernel of microseconds is faster than the wrapper's host
path). The bound is chip_smoke's `chain_bound` or `preint_bound`.
The check before it holds the kernel to the plain version on a chain of
capacity 256 (the plain chain is a Python loop) at chip_smoke's
`CHAIN_RTOL`, and on the timed preintegration inputs to 1e-10 of the
largest entry in float64 (float32: within 4 times the plain float32's own
distance from the plain float64, floor 1e-4, as phase 14). Prints each
kernel's `-Xptxas -v` lines, one line per launch and the card's name and
power limit, and writes the records as JSON to FILE.

To compare two trees on one card, run this file from one tree with the
other tree's root first on PYTHONPATH: the package, and the kernels it
builds, are then the other tree's, while the shapes, timer and bounds are
those of the chip_smoke.py beside this file.
"""

import argparse
import importlib.util
import json
from pathlib import Path

import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.ops import _build, chain


def _chip_smoke():
    """chip_smoke.py of this file's tree, whichever package is imported."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHAIN_CASES = ((3, torch.float32, 16384), (4, torch.float32, 16384),
               (6, torch.float32, 16384), (15, torch.float64, 512))
PREINT_CASES = (1, 2000)
# preint_rotation: (mode, segments, dtype)
ROTATION_CASES = tuple((m, S, torch.float64) for m in ("manifold", "ahrs")
                       for S in PREINT_CASES) + (
    ("manifold", 2000, torch.float32), ("ahrs", 2000, torch.float32))
KERNELS = ("chain", "tangent", "rotation")


def _rel_err(got, ref):
    """Largest |got - ref| of the outputs, each over its largest entry."""
    return max(((a.double() - b).abs().max() / b.abs().max().clamp_min(
        1e-300)).item() for a, b in zip(got, ref))


def time_rotation(cs, dev):
    """The records of ROTATION_CASES."""
    covs = cs._preint_covs(dev)
    recs, plain = [], {}
    for mode, S, dtype in ROTATION_CASES:
        in64 = cs._preint_inputs([cs.PREINT_N] * S, torch.float64, dev, S)
        inputs = tuple(x.to(dtype) for x in in64)
        c = covs.to(dtype)
        if (mode, S) not in plain:
            plain[mode, S] = cs._preint_call(mode, in64, covs, plain=True)
        kernel = cs._preint_launcher(mode, inputs, c)
        rel = _rel_err(kernel(), plain[mode, S])
        if dtype == torch.float64:
            ok = rel <= 1e-10
        else:
            own = _rel_err(cs._preint_call(mode, inputs, c, plain=True),
                           plain[mode, S])
            ok = rel <= max(4 * own, 1e-4)
        if not ok:
            raise RuntimeError(f"preint_rotation {mode} S={S} {dtype}: {rel}")
        ms = cs._time_ms(kernel, 20 if S == 1 else 10)
        device_ms = cs._graph_ms(kernel, 20)
        bound_ms, _, what = cs.preint_bound(mode, S, cs.PREINT_N,
                                            dtype.itemsize)
        recs.append({"kernel": "preint_rotation", "mode": mode, "S": S,
                     "N": cs.PREINT_N, "dtype": str(dtype)[6:], "ms": ms,
                     "device_ms": device_ms,
                     "check_err_rel": rel, "bound_ms": bound_ms,
                     "bound_share": bound_ms / ms, "bound": what})
    return recs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="which of chain, tangent, rotation to time")
    args = ap.parse_args()
    which = args.kernels.split(",")
    if not set(which) <= set(KERNELS):
        ap.error(f"--kernels: {args.kernels!r}, choose from {KERNELS}")
    cs = _chip_smoke()
    dev = config.device("cuda")
    card = cs.card_line()
    path = _build.build()
    for line in path.with_suffix(".so.log").read_text().splitlines():
        if any(k in line for k in ("chain_factorize", "preint_tangent",
                                   "preint_rotation", "registers", "stack")):
            print(f"ptxas: {line.strip()}")
    recs = []
    for d, dtype, cap in CHAIN_CASES if "chain" in which else ():
        Dm, Om = chain.chain_prepare(*(x.to(dtype) for x in
                                       cs._spd_chain(d, 256, dev, d)),
                                     256, cs.CHAIN_LAM)
        ref = chain.chain_factorize_ref(Dm, Om)
        err = (chain.chain_factorize(Dm, Om) - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= cs.CHAIN_RTOL[dtype] * scale:
            raise RuntimeError(f"chain d={d} {dtype}: {err} of {scale}")
        Dm, Om = chain.chain_prepare(*(x.to(dtype) for x in
                                       cs._spd_chain(d, cap, dev, d)),
                                     cap, cs.CHAIN_LAM)
        ms = cs._time_ms(lambda: chain.chain_factorize(Dm, Om), 20)
        bound_ms, _, what = cs.chain_bound(cap, d, dtype.itemsize)
        recs.append({"kernel": "chain_factorize", "d": d,
                     "dtype": str(dtype)[6:], "cap": cap, "ms": ms,
                     "ns_per_step": ms * 1e6 / cap,
                     "check_err_rel": err / scale, "bound_ms": bound_ms,
                     "bound_share": bound_ms / ms, "bound": what})
    covs = cs._preint_covs(dev)
    for S in PREINT_CASES if "tangent" in which else ():
        inputs = cs._preint_inputs([cs.PREINT_N] * S, torch.float64, dev, S)
        got = cs._preint_call("tangent", inputs, covs)
        ref = cs._preint_call("tangent", inputs, covs, plain=True)
        rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(got, ref))
        if not rel <= 1e-10:
            raise RuntimeError(f"preint_tangent S={S}: {rel}")
        kernel = cs._preint_launcher("tangent", inputs, covs)
        ms = cs._time_ms(kernel, 20 if S == 1 else 10)
        device_ms = cs._graph_ms(kernel, 20)
        bound_ms, _, what = cs.preint_bound("tangent", S, cs.PREINT_N, 8)
        recs.append({"kernel": "preint_tangent", "S": S, "N": cs.PREINT_N,
                     "dtype": "float64", "ms": ms, "device_ms": device_ms,
                     "us_per_step": ms * 1e3 / cs.PREINT_N,
                     "check_err_rel": rel, "bound_ms": bound_ms,
                     "bound_share": bound_ms / ms, "bound": what})
    if "rotation" in which:
        recs += time_rotation(cs, dev)
    for r in recs:
        print(f"{args.label} {json.dumps(r)}")
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "label": args.label, "records": recs},
                      f, indent=1)


if __name__ == "__main__":
    main()
