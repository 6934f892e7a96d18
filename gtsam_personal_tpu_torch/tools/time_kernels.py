"""Time the chain and tangent-preintegration kernels on the card, each held
against its plain version first, beside its bound.

    python -m gtsam_personal_tpu_torch.tools.time_kernels [--out FILE]

Launches (the shapes of chip_smoke.py's phases 8, 14 and 17):
`chain_factorize` at d = 3, 4 and 6 in float32 at capacity 16384 and at
d = 15 in float64 at capacity 512, on chip_smoke's seeded block-tridiagonal
SPD chains; `preint_tangent` in float64 for one segment of 200 samples and
for 2000 segments of 200, on phase 14's inputs. Each time is the mean of a
run of launches between two CUDA events, after a warm-up (chip_smoke's
`_time_ms`); the bound is chip_smoke's `chain_bound` or `preint_bound`.
The check before it holds the kernel to the plain version on a chain of
capacity 256 (the plain chain is a Python loop) at chip_smoke's
`CHAIN_RTOL`, and on the timed preintegration inputs to 1e-10. Prints one
line per launch and the card's name and power limit, and writes the
records as JSON to FILE.

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    cs = _chip_smoke()
    dev = config.device("cuda")
    card = cs.card_line()
    path = _build.build()
    for line in path.with_suffix(".so.log").read_text().splitlines():
        if "chain_factorize" in line or "preint_tangent" in line or (
                "registers" in line or "stack" in line):
            print(f"ptxas: {line.strip()}")
    recs = []
    for d, dtype, cap in CHAIN_CASES:
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
    for S in PREINT_CASES:
        inputs = cs._preint_inputs([cs.PREINT_N] * S, torch.float64, dev, S)
        got = cs._preint_call("tangent", inputs, covs)
        ref = cs._preint_call("tangent", inputs, covs, plain=True)
        rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(got, ref))
        if not rel <= 1e-10:
            raise RuntimeError(f"preint_tangent S={S}: {rel}")
        ms = cs._time_ms(lambda: cs._preint_call("tangent", inputs, covs),
                         20 if S == 1 else 10)
        bound_ms, _, what = cs.preint_bound("tangent", S, cs.PREINT_N, 8)
        recs.append({"kernel": "preint_tangent", "S": S, "N": cs.PREINT_N,
                     "dtype": "float64", "ms": ms,
                     "us_per_step": ms * 1e3 / cs.PREINT_N,
                     "check_err_rel": rel, "bound_ms": bound_ms,
                     "bound_share": bound_ms / ms, "bound": what})
    for r in recs:
        print(f"{args.label} {json.dumps(r)}")
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "label": args.label, "records": recs},
                      f, indent=1)


if __name__ == "__main__":
    main()
