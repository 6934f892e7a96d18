"""Build and load the package's CUDA kernels: nvcc into a shared library
with a plain C interface, loaded with ctypes.

The library is compiled at first use for sm_90a (Hopper) into
`build/kernels/` at the root of the checkout, under a name keyed by a hash
of the sources and flags, so a changed source is rebuilt and an unchanged
one is loaded as it is. No PyTorch header is included, which keeps a build
to seconds. A failed build raises with nvcc's messages.
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
SOURCES = (_PKG / "csrc" / "landmark_block_solve.cu",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
# -fmad=false: see csrc/landmark_block_solve.cu, "Arithmetic order".
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
_ENTRY_POINTS = ("landmark_block_solve_f32", "landmark_block_solve_f64")


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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    out.with_suffix(".so.log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, out)            # atomic: a reader never sees half a file
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with argtypes set: four pointers (H, t, lam, u),
    P as int64 and the CUDA stream; each returns cudaGetLastError()."""
    lib = ctypes.CDLL(str(build()))
    for name in _ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
