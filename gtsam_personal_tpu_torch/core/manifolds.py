"""Manifold registry: what makes a variable type optimizable.

JAX counterpart: gtsam_personal_tpu/core/manifolds.py (all of it; reference:
the traits system, gtsam/base/Manifold.h:92). A manifold is a record of pure
functions over fixed-shape tensors; the variables of one manifold are stored
stacked as [N, *param_shape].

`retract` and `local` are written for ONE element, as the JAX package's are
(the built-in ones also take leading batch axes); `batched_retract` and
`batched_local` run them over a stacked block with `torch.func.vmap`, so a
manifold that a user registers needs no batch handling of its own.
"""

from typing import Callable, NamedTuple, Tuple

import torch

from gtsam_personal_tpu_torch.geometry import se2, se3, so2, so3


class Manifold(NamedTuple):
    name: str
    dim: int                      # tangent dimension
    param_shape: Tuple[int, ...]  # storage shape of one element
    retract: Callable             # (point, tangent[dim]) -> point
    local: Callable               # (point, point) -> tangent[dim]
    identity: Callable            # (*, device, dtype) -> point


def _vector_space(name, d):
    """R^d as a trivial manifold (reference: base/VectorSpace.h)."""
    return Manifold(
        name=name, dim=d, param_shape=(d,),
        retract=lambda p, x: p + x,
        local=lambda a, b: b - a,
        identity=lambda *, device, dtype: torch.zeros(d, device=device,
                                                      dtype=dtype),
    )


SO2 = Manifold("so2", so2.TANGENT_DIM, so2.PARAM_SHAPE, so2.retract,
               so2.local, so2.identity)
SE2 = Manifold("se2", se2.TANGENT_DIM, se2.PARAM_SHAPE, se2.retract,
               se2.local, se2.identity)
SO3 = Manifold("so3", so3.TANGENT_DIM, so3.PARAM_SHAPE, so3.retract,
               so3.local, so3.identity)
SE3 = Manifold("se3", se3.TANGENT_DIM, se3.PARAM_SHAPE, se3.retract,
               se3.local, se3.identity)
R1 = _vector_space("r1", 1)
R2 = _vector_space("r2", 2)
R3 = _vector_space("r3", 3)
R6 = _vector_space("r6", 6)
R9 = _vector_space("r9", 9)

POINT2 = R2._replace(name="point2")
POINT3 = R3._replace(name="point3")
VEL3 = R3._replace(name="vel3")
# (acc_bias, gyro_bias), reference ImuBias::ConstantBias
IMU_BIAS = R6._replace(name="imu_bias")

_REGISTRY = {}


def register(m: Manifold):
    _REGISTRY[m.name] = m
    return m


for _m in (SO2, SE2, SO3, SE3, R1, R2, R3, R6, R9, POINT2, POINT3, VEL3,
           IMU_BIAS):
    register(_m)


def get(name: str) -> Manifold:
    return _REGISTRY[name]


def vector_space(name: str, d: int) -> Manifold:
    """Get-or-create an R^d manifold under a custom group name."""
    if name not in _REGISTRY:
        register(_vector_space("r%d" % d, d)._replace(name=name))
    return _REGISTRY[name]


def batched_retract(m: Manifold, points, tangents):
    """Retract a stacked [N, *param_shape] block by tangents [N, dim]."""
    return torch.func.vmap(m.retract)(points, tangents)


def batched_local(m: Manifold, a, b):
    return torch.func.vmap(m.local)(a, b)
