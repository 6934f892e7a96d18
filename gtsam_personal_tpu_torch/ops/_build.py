"""Build and load the package's CUDA kernels: nvcc into a shared library
with a plain C interface, loaded with ctypes.

The library is compiled at first use for sm_90a (Hopper) into
`build/kernels/` at the root of the checkout, under a name keyed by a hash
of the sources and flags, so a changed source is rebuilt and an unchanged
one is loaded as it is. Each source is compiled by an nvcc of its own, all
started together, and one more nvcc links the objects. No PyTorch header is
included, which keeps a build to seconds. A failed build raises with nvcc's
messages.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in (
    "landmark_block_solve.cu", "chain_factorize.cu", "preint_tangent.cu",
    "preint_rotation.cu"))
BUILD_DIR = _PKG.parent / "build" / "kernels"
# -fmad=false: see csrc/landmark_block_solve.cu, "Arithmetic order"; it holds
# for every source, and csrc/chain_factorize.cu calls fma() where it wants one.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_VOID_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# entry point -> argument types; each returns cudaGetLastError()
_ENTRY_POINTS = {
    # H, t, lam, u, P, stream
    "landmark_block_solve_f32": [_VOID_P] * 4 + [_I64, _VOID_P],
    "landmark_block_solve_f64": [_VOID_P] * 4 + [_I64, _VOID_P],
    # D, O, Uinv, cap, d, stream (-1: a block size that is not built)
    "chain_factorize_f32": [_VOID_P] * 3 + [_I64, _INT, _VOID_P],
    "chain_factorize_f64": [_VOID_P] * 3 + [_I64, _INT, _VOID_P],
    # accs, gyros, dts, bias, covs, zeta, H, cov, dT, S, N, stream
    "preint_tangent_f32": [_VOID_P] * 9 + [_I64, _I64, _VOID_P],
    "preint_tangent_f64": [_VOID_P] * 9 + [_I64, _I64, _VOID_P],
    # mode, accs, gyros, dts, bias, gyro_cov, R, dR, p, v, dp, dv, cov, S, N,
    # stream (-1: a mode that does not exist)
    "preint_rotation_f32": [_INT] + [_VOID_P] * 12 + [_I64, _I64, _VOID_P],
    "preint_rotation_f64": [_INT] + [_VOID_P] * 12 + [_I64, _I64, _VOID_P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home
                  else []) + ["/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and $PATH)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgtsam_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the keyed library exists; returns its
    path. nvcc's report (registers and spills per kernel, from -Xptxas -v)
    is kept beside it as `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [str(Path(work) / (src.stem + ".o")) for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for obj, src in zip(objs, SOURCES)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        results = [(cmd, proc, *proc.communicate())
                   for cmd, proc in zip(cmds, procs)]   # waits for every one
        tmp = str(Path(work) / "lib.so")
        link = [nvcc, *NVCC_FLAGS, "-o", tmp, *objs]
        if all(proc.returncode == 0 for _, proc, _, _ in results):
            proc = subprocess.run(link, capture_output=True, text=True)
            results.append((link, proc, proc.stdout, proc.stderr))
        for cmd, proc, stdout, stderr in results:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{stderr}{stdout}")
            log.append(stderr + stdout)
        out.with_suffix(".so.log").write_text("".join(log))
        os.replace(tmp, out)        # atomic: a reader never sees half a file
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with the argument types of every entry point
    set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
