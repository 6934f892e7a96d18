"""Every residual of the port's slam/factors.py and slam/unstable.py against
the JAX package's, float64 on the CPU: the residual and every slot's
Jacobian through each package's `linearize_batch`.

The inputs are the seeded batches of tools/factor_samples.py (8 factors a
name), the same numpy arrays for both packages. Tolerance: rtol 1e-10 with
an atol of 1e-10 times the largest entry of the array compared, since two
evaluation orders of one entry that cancels to ~1e-16 agree in no relative
digit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core import graph as jgraph, manifolds as jman
from gtsam_personal_tpu.geometry import extra as _jextra  # noqa: F401
from gtsam_personal_tpu.geometry import fundamental as _jfund  # noqa: F401
from gtsam_personal_tpu.linear import linearize as jlin, noise as jnoise
from gtsam_personal_tpu.navigation import (dynamics as JD, factors as JNF,
                                           preintegration as JPRE)
from gtsam_personal_tpu.slam import factors as JF, unstable as JU
from gtsam_personal_tpu_torch.core.graph import FactorBatch
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.linearize import linearize_batch
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.navigation import (dynamics as DYN,
                                                  factors as NAV,
                                                  preintegration as PRE)
from gtsam_personal_tpu_torch.slam import factors as F, unstable as U
from gtsam_personal_tpu_torch.tools import factor_samples

jman.vector_space("event", 4)
K = 8
RTOL = 1e-10
j_linearize_batch = jax.jit(jlin.linearize_batch)


def jax_residual(name):
    """The JAX package's residual function of the batch name `name`."""
    for prefix, make in (("between_sensor_", JF.make_between_sensor_residual),
                         ("prior_sensor_", JF.make_prior_sensor_residual),
                         ("between_em_", JU.make_between_em_residual),
                         ("prior_", JF.make_prior_residual),
                         ("between_", JF.make_between_residual)):
        if name.startswith(prefix):
            return make(name[len(prefix):])
    if name.startswith("reference_frame_"):
        g = name.rsplit("_", 1)[1]
        return JF.make_reference_frame_residual(
            "point3" if g == "se3" else "point2", g)
    if name.startswith("velocity_constraint_"):
        return JD.make_velocity_constraint_residual(
            name[len("velocity_constraint_"):])
    mod = next(m for m in (JU, JNF, JD, JPRE, JF)
               if hasattr(m, name + "_residual"))
    return getattr(mod, name + "_residual")


def _blocks(groups, points):
    """Values blocks and the index table of one batch: slot s reads its own
    K rows of its group's block."""
    blocks, idx = {}, []
    for g, p in zip(groups, points):
        off = blocks[g].shape[0] if g in blocks else 0
        blocks[g] = np.concatenate([blocks[g], p]) if g in blocks else p
        idx.append(np.arange(K) + off)
    return blocks, np.stack(idx, 1)


def assert_close(got, ref, what):
    ref = np.asarray(ref)
    atol = RTOL * max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL, atol=atol,
                               err_msg=what)


def linearize_both(name, tfn, jfn, groups, rdim, points, meas):
    blocks, idx = _blocks(groups, points)
    jb = jgraph.FactorBatch(name, jfn, groups, rdim, jnp.asarray(idx),
                            {k: jnp.asarray(v) for k, v in meas.items()},
                            jnoise.NoiseModel("unit"))
    from gtsam_personal_tpu.core.values import Values as JValues
    jl = j_linearize_batch(jb, JValues({g: jnp.asarray(p)
                                        for g, p in blocks.items()}))
    tb = FactorBatch(name, tfn, groups, rdim, torch.tensor(idx),
                     {k: torch.tensor(v) for k, v in meas.items()},
                     NoiseModel("unit"))
    tl = linearize_batch(tb, Values({g: torch.tensor(p)
                                     for g, p in blocks.items()}))
    assert_close(tl.r.numpy(), jl.r, f"{name}: residual")
    for s, (Jt, Jj) in enumerate(zip(tl.Js, jl.Js)):
        assert_close(Jt.numpy(), Jj, f"{name}: Jacobian of slot {s}")
    assert np.isfinite(tl.r.numpy()).all()
    return tl


@pytest.mark.parametrize("name", F.residual_names())
def test_residual_and_jacobians_match_jax(name):
    s = factor_samples.sample(name, K, seed=3)
    tl = linearize_both(name, F.residual_by_name(name), jax_residual(name),
                        s["groups"], s["rdim"], s["points"], s["meas"])
    assert tl.r.shape == (K, s["rdim"])


def _partial_prior_case():
    s = factor_samples.sample("prior_se3", K, seed=4)
    x = s["points"][0]
    from gtsam_personal_tpu_torch.geometry import se3
    full = se3.logmap(torch.tensor(x)).numpy()
    meas = {"prior": full[:, [2, 5]] + 0.1}
    return (("se3",), 2, [x], meas)


@pytest.mark.parametrize("case", ["partial_prior", "bounding_constraint_gt",
                                  "bounding_constraint_lt"])
def test_factories_that_hold_more_than_groups(case):
    """The two factories that residual_by_name refuses: their closures hold
    indices and a value function, which the test passes to both packages."""
    if case == "partial_prior":
        groups, rdim, points, meas = _partial_prior_case()
        tfn = F.make_partial_prior_residual("se3", [2, 5])
        jfn = JF.make_partial_prior_residual("se3", [2, 5])
        name = "partial_prior_se3"
    else:
        s = factor_samples.sample("range_bound", K, seed=5)
        groups, rdim, points = s["groups"], 1, s["points"]
        meas = s["meas"]
        greater = case.endswith("gt")

        def value(lib):
            def fn(xs, meas):
                a, b = xs
                d = b[..., :2] - a[..., :2]
                return lib.sqrt((d * d).sum(-1))
            return fn
        tfn = F.make_bounding_constraint_residual(value(torch), greater)
        jfn = JF.make_bounding_constraint_residual(value(jnp), greater)
        name = "bounding_constraint"
    linearize_both(name, tfn, jfn, groups, rdim, points, meas)
    with pytest.raises(ValueError, match="register_residual"):
        F.residual_by_name(name)


def test_names_cover_both_modules():
    """Every module-level residual of the JAX modules (slam factors,
    unstable, navigation factors, dynamics, AHRS) has a name here, and the
    names resolve to functions of the port's modules."""
    names = set(F.residual_names())
    for mod in (JF, JU, JNF, JD, JPRE):
        for attr in dir(mod):
            if attr.endswith("_residual") and not attr.startswith("make_"):
                assert attr[:-len("_residual")] in names, attr
    port = {m.__name__ for m in (F, U, NAV, DYN, PRE)}
    for name in names:
        fn = F.residual_by_name(name)
        assert fn.__module__ in port, (name, fn)

