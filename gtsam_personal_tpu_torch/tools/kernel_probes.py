"""Latency probes of the card and the per-role cycles of preint_tangent's
pipeline: two CUDA programs under tools/probes/, built with nvcc for sm_90a
into build/probes/ and run, their lines printed.

    python -m gtsam_personal_tpu_torch.tools.kernel_probes

`latency.cu` gives the dependent latency, in SM cycles, of the operations
that the kernels' chains are made of (fma, the reciprocals and divisions,
sqrt, sincos, a shared-memory round trip); `preint_roles.cu` runs
csrc/preint_tangent.cu's loop on one segment with clock64() around each
role. A card is required: the programs run nowhere else.
"""

import subprocess
import sys
from pathlib import Path

from gtsam_personal_tpu_torch.ops import _build

PROBES = Path(__file__).resolve().parent / "probes"
OUT = _build.BUILD_DIR.parent / "probes"


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    for name in ("latency", "preint_roles"):
        exe = OUT / name
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-fmad=false", "-o", str(exe),
                        str(PROBES / f"{name}.cu")], check=True)
        out = subprocess.run([str(exe)], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            raise RuntimeError(f"{name} failed ({out.returncode}): "
                               f"{out.stderr}")


if __name__ == "__main__":
    main()
