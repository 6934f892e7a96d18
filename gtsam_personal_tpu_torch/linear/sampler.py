"""Sampling from Gaussian noise models, and weighted discrete sampling.

JAX counterpart: gtsam_personal_tpu/linear/sampler.py (all of it;
reference: gtsam/linear/Sampler.h, noise vectors distributed as a noise
model says, and gtsam/base/WeightedSampler.h, weighted sampling without
replacement).

Draws come from an explicit `torch.Generator`, which lives on the device
of the draw (the JAX package's `jax.random` keys have no torch
counterpart). The
deterministic part of each draw is a function of its own that takes the
random numbers as an argument: `noise_from_standard` (v = S^{-1} z) and
`weighted_keys_order` (the Efraimidis-Spirakis keys).
"""

import torch

from gtsam_personal_tpu_torch.linear.noise import NoiseModel


def noise_from_standard(noise: NoiseModel, z):
    """v ~ N(0, Sigma) from z ~ N(0, I) [..., dim]: with the square-root
    information S (S^T S = Sigma^{-1}), v = S^{-1} z."""
    if noise.kind == "diag":
        return z / noise.data
    S = noise.data.expand(z.shape[:-1] + noise.data.shape[-2:])
    return torch.linalg.solve(S, z[..., None])[..., 0]


def sample_noise(generator: torch.Generator, noise: NoiseModel,
                 shape_prefix=()):
    """Draw v ~ N(0, Sigma) of the noise model, shape shape_prefix + (dim,),
    on the device of its data."""
    if noise.kind == "unit":
        raise ValueError("unit noise model needs an explicit dimension; "
                         "use sample_standard")
    z = torch.randn(tuple(shape_prefix) + (noise.data.shape[-1],),
                    generator=generator, dtype=noise.data.dtype,
                    device=noise.data.device)
    return noise_from_standard(noise, z)


def sample_standard(generator: torch.Generator, dim, shape_prefix=(),
                    dtype=torch.float32):
    """z ~ N(0, I), shape shape_prefix + (dim,), on the generator's
    device."""
    return torch.randn(tuple(shape_prefix) + (dim,), generator=generator,
                       dtype=dtype, device=generator.device)


def weighted_keys_order(weights, u, k: int):
    """The k indices of the largest Efraimidis-Spirakis keys log(u) / w,
    for uniform draws u in (0, 1) beside the weights."""
    keys = torch.log(u) / torch.clamp(weights, min=1e-30)
    return torch.argsort(-keys)[:k]


def weighted_sample_without_replacement(generator: torch.Generator, weights,
                                        k: int):
    """k indices sampled without replacement with probability proportional
    to `weights` (a tensor; reference: base/WeightedSampler.h)."""
    u = torch.rand(weights.shape, generator=generator, dtype=weights.dtype,
                   device=weights.device)
    return weighted_keys_order(weights, 1e-12 + (1.0 - 1e-12) * u, k)
