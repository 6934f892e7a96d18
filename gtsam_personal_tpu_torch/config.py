"""Numeric configuration and device selection.

JAX counterpart: gtsam_personal_tpu/config.py:default_dtype. Functions in
this package inherit the dtype of their inputs, as the JAX package does, so
there is no default dtype here.

TF32 is off, explicitly: a float32 product in TF32 keeps about three decimal
digits, the GPU counterpart of the bf16 lowering that sent the TPU's chain
preconditioner to NaN while float32 converged on the CPU. Never raise
`torch.set_float32_matmul_precision` above "highest" in this package.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def device(name) -> torch.device:
    """`torch.device(name)` of a name or a device; raises for a CUDA device
    when none is present, instead of letting the caller run on the CPU
    unawares."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev
