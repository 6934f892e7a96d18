"""The port's factor graph, noise models and linearization against the JAX
package, in float64 on the CPU.

A graph is built once with the JAX package's GraphBuilder; its arrays are pulled
out as numpy and handed to the port's `graph_from_numpy` /
`values_from_numpy`, so both packages work on the same numbers. The port
never sees a JAX type."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core import graph as jgraph_mod, values as jvalues_mod
from gtsam_personal_tpu.geometry import se2 as jse2, se3 as jse3
from gtsam_personal_tpu.linear import linearize as jlin, noise as jnoise
from gtsam_personal_tpu.slam import factors as JF
from gtsam_personal_tpu_torch.core import graph as graph_mod, values as values_mod
from gtsam_personal_tpu_torch.linear import linearize as lin_mod, noise
from gtsam_personal_tpu_torch.slam import factors as F

F64 = torch.float64
# whole-function compiles: faster here than JAX's op-by-op dispatch
j_linearize = jax.jit(jlin.linearize)
j_linearize_batch = jax.jit(jlin.linearize_batch)
j_error = jax.jit(lambda g, v: g.error(v))


def j_assemble(jl, jlayout):
    return jax.jit(lambda lin: lin.assemble_dense(jlayout))(jl)


def _np(x):
    return None if x is None else np.asarray(x)


def jax_graph_to_numpy(jgraph):
    """What a JAX FactorGraph holds, as numpy arrays and plain Python."""
    return [{"name": b.name, "groups": b.groups, "rdim": b.rdim,
             "idx": _np(b.idx),
             "meas": {k: _np(v) for k, v in b.meas.items()},
             "noise": {"kind": b.noise.kind, "data": _np(b.noise.data),
                       "robust": b.noise.robust, "k": _np(b.noise.k)},
             "sign": b.sign} for b in jgraph.batches]


def port_graph(jgraph, dtype=F64):
    return graph_mod.graph_from_numpy(jax_graph_to_numpy(jgraph),
                                      F.residual_by_name, device="cpu",
                                      dtype=dtype)


def port_values(jvalues, dtype=F64):
    return values_mod.values_from_numpy(
        {g: _np(x) for g, x in jvalues.blocks.items()}, device="cpu",
        dtype=dtype)


def _add_both(gbs, mods, kind, group, *args):
    for b, mod in zip(gbs, mods):
        getattr(mod, f"add_{kind}")(b, group, *args)


def _ring64(gbs, mods):
    """The 64-pose SE(2) ring with loop closures that the JAX package's
    entry module builds (its `_synthetic_pose_graph`), added to every
    GraphBuilder given; returns the initial poses."""
    n = 64
    rng = np.random.default_rng(0)
    _add_both(gbs, mods, "prior", "se2", 0, np.zeros(3),
              F.diag_noise([0.3, 0.3, 0.1]))
    truth = np.zeros((n, 3))
    step = np.array([1.0, 0.0, 2 * np.pi / n])
    for i in range(n - 1):
        c, s = np.cos(truth[i, 2]), np.sin(truth[i, 2])
        truth[i + 1] = truth[i] + [c * step[0] - s * step[1],
                                   s * step[0] + c * step[1], step[2]]
        _add_both(gbs, mods, "between", "se2", i, i + 1,
                  step + rng.normal(scale=0.01, size=3),
                  F.diag_noise([0.05, 0.05, 0.02]))
    for i in range(0, n - n // 4, n // 8):
        j = i + n // 4
        rel = np.asarray(jse2.between(jnp.asarray(truth[i]),
                                      jnp.asarray(truth[j])))
        _add_both(gbs, mods, "between", "se2", i, j,
                  rel + rng.normal(scale=0.01, size=3),
                  F.diag_noise([0.05, 0.05, 0.02]))
    return truth + rng.normal(scale=0.1, size=truth.shape)


def _se3_chain(gbs, mods, n=24):
    """SE(3) prior + odometry + closures with full-information noise on the
    closures; returns the initial poses [n, 3, 4]."""
    rng = np.random.default_rng(1)
    xi = np.concatenate([0.3 * rng.normal(size=(n, 3)),
                         2.0 * rng.normal(size=(n, 3))], axis=1)
    truth = np.asarray(jax.vmap(jse3.expmap)(jnp.asarray(xi)))
    rel = lambda i, j: np.asarray(jse3.between(jnp.asarray(truth[i]),
                                               jnp.asarray(truth[j])))
    _add_both(gbs, mods, "prior", "se3", 0, truth[0],
              F.diag_noise([0.01] * 3 + [0.05] * 3))
    for i in range(n - 1):
        _add_both(gbs, mods, "between", "se3", i, i + 1, rel(i, i + 1),
                  F.diag_noise([0.02] * 3 + [0.1] * 3))
    for i in range(0, n - 6, 5):
        A = rng.normal(size=(6, 6))
        _add_both(gbs, mods, "between", "se3", i, i + 6, rel(i, i + 6),
                  F.full_info_noise(A @ A.T + 6.0 * np.eye(6)))
    noise_xi = 0.05 * rng.normal(size=(n, 6))
    return np.asarray(jax.vmap(jse3.retract)(jnp.asarray(truth),
                                             jnp.asarray(noise_xi)))


class Case:
    """One graph in both packages, with both linearizations."""

    def __init__(self, fill, group):
        jb = jgraph_mod.GraphBuilder()
        init = fill([jb], [JF])
        self.jgraph = jb.build(dtype=np.float64)
        self.jvalues = jvalues_mod.Values({group: jnp.asarray(init)})
        self.graph = port_graph(self.jgraph)
        self.values = port_values(self.jvalues)
        self.jlin = j_linearize(self.jgraph, self.jvalues)
        self.lin = lin_mod.linearize(self.graph, self.values)
        self.jlayout = jvalues_mod.Layout.of(self.jvalues)
        self.layout = values_mod.Layout.of(self.values)


@pytest.fixture(scope="module")
def cases():
    return {"se2_ring64": Case(_ring64, "se2"),
            "se3_chain": Case(_se3_chain, "se3")}


CASES = ["se2_ring64", "se3_chain"]


def _close(got, ref, rtol=1e-10, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


# --- building ---------------------------------------------------------------

@pytest.mark.parametrize("fill,group", [(_ring64, "se2"), (_se3_chain, "se3")])
def test_graph_build_stacks_the_same_batches(fill, group):
    """The port's GraphBuilder, fed the same `add` calls, stacks the same
    batches as the JAX one: order, names, indices, measurements, noise."""
    jb, b = jgraph_mod.GraphBuilder(), graph_mod.GraphBuilder()
    fill([jb, b], [JF, F])
    jg, g = jb.build(dtype=np.float64), b.build(device="cpu", dtype=F64)
    assert len(g.batches) == len(jg.batches)
    assert g.num_factors == jg.num_factors
    for pb, jbatch in zip(g.batches, jg.batches):
        assert (pb.name, pb.groups, pb.rdim, pb.sign, pb.noise.kind,
                pb.noise.robust) == (jbatch.name, jbatch.groups, jbatch.rdim,
                                     jbatch.sign, jbatch.noise.kind,
                                     jbatch.noise.robust)
        assert pb.idx.dtype == torch.int64
        np.testing.assert_array_equal(pb.idx.numpy(), np.asarray(jbatch.idx))
        assert sorted(pb.meas) == sorted(jbatch.meas)
        for k in pb.meas:
            np.testing.assert_array_equal(pb.meas[k].numpy(),
                                          np.asarray(jbatch.meas[k]))
        np.testing.assert_array_equal(pb.noise.data.numpy(),
                                      np.asarray(jbatch.noise.data))


def test_graph_from_numpy_rejects_unknown_residual():
    with pytest.raises(ValueError, match="no residual function"):
        graph_mod.graph_from_numpy(
            [{"name": "no_such_factor", "groups": ("se3", "point3"),
              "rdim": 3,
              "idx": np.zeros((1, 2)), "meas": {}, "noise": {"kind": "unit"}}],
            F.residual_by_name, device="cpu", dtype=F64)


def test_values_container(cases):
    c = cases["se2_ring64"]
    v, jv = c.values, c.jvalues
    assert v.counts() == jv.counts() and v.groups() == jv.groups()
    assert v.tangent_dim() == jv.tangent_dim() == 192
    rng = np.random.default_rng(2)
    d = 0.1 * rng.normal(size=(64, 3))
    mask = rng.random(64) < 0.5
    _close(v.retract({"se2": torch.tensor(d)})["se2"],
           jv.retract({"se2": jnp.asarray(d)})["se2"], rtol=1e-12)
    moved = v.retract_masked({"se2": torch.tensor(d)},
                             {"se2": torch.tensor(mask)})
    _close(moved["se2"], jv.retract_masked(
        {"se2": jnp.asarray(d)}, {"se2": jnp.asarray(mask)})["se2"],
        rtol=1e-12)
    np.testing.assert_array_equal(moved["se2"][~mask].numpy(),
                                  v["se2"][~mask].numpy())
    _close(v.local(moved)["se2"], jv.local(jvalues_mod.Values(
        {"se2": jnp.asarray(moved["se2"].numpy())}))["se2"], rtol=1e-9,
        atol=1e-14)
    z = v.zero_tangent()
    assert z["se2"].shape == (64, 3) and not z["se2"].any()
    lay = c.layout
    flat = lay.flatten({"se2": torch.tensor(d)})
    np.testing.assert_array_equal(flat.numpy(), d.reshape(-1))
    np.testing.assert_array_equal(lay.unflatten(flat)["se2"].numpy(), d)
    assert lay.var_offset("se2", 5) == c.jlayout.var_offset("se2", 5) == 15
    a, b = {"se2": torch.tensor(d)}, {"se2": torch.tensor(d[::-1].copy())}
    ja, jb = {"se2": jnp.asarray(d)}, {"se2": jnp.asarray(d[::-1].copy())}
    _close(values_mod.tree_vdot(a, b), jvalues_mod.tree_vdot(ja, jb),
           rtol=1e-12)
    _close(values_mod.tree_norm(a), jvalues_mod.tree_norm(ja), rtol=1e-12)
    _close(values_mod.tree_axpy(0.5, a, b)["se2"],
           jvalues_mod.tree_axpy(0.5, ja, jb)["se2"], rtol=1e-14)
    _close(values_mod.tree_sub(values_mod.tree_add(a, b), b)["se2"],
           jvalues_mod.tree_sub(jvalues_mod.tree_add(ja, jb), jb)["se2"],
           rtol=1e-14)
    assert not values_mod.tree_zeros_like(a)["se2"].any()


# --- error and whitening ----------------------------------------------------

@pytest.mark.parametrize("which", CASES)
def test_graph_error(cases, which):
    c = cases[which]
    err = c.graph.error(c.values)
    assert err.dim() == 0
    _close(err, j_error(c.jgraph, c.jvalues))


def test_negated_batch_cancels(cases):
    c = cases["se2_ring64"]
    g = graph_mod.FactorGraph(c.graph.batches + [c.graph.batches[1].negated()])
    jg = jgraph_mod.FactorGraph(c.jgraph.batches
                                + [c.jgraph.batches[1].negated()])
    assert g.batches[-1].name == "between_se2_anti"
    _close(g.error(c.values), j_error(jg, c.jvalues), rtol=1e-9)
    _close(g.error(c.values), c.graph.batches[0].error(c.values), rtol=1e-9)
    # carried across by name, `_anti` suffix and sign included
    g2 = port_graph(jg)
    assert g2.batches[-1].sign == -1.0
    H, gv = lin_mod.linearize(g2, c.values).assemble_dense(c.layout)
    jH, jgv = j_assemble(j_linearize(jg, c.jvalues), c.jlayout)
    _close(H, jH, atol=1e-7)        # cancelled blocks: ~1e5 - 1e5
    _close(gv, jgv, atol=1e-7)


def _noise_pairs(kind, K, r, rng):
    """The same noise model in both packages: (jax model, port model)."""
    kw = dict(device="cpu", dtype=F64)
    if kind == "unit":
        return jnoise.unit(), noise.unit()
    if kind == "diag":
        s = rng.uniform(0.05, 2.0, size=(K, r))
        s[0, 0] = 0.0                      # sigma == 0 -> penalty weight
        return jnoise.sigmas(jnp.asarray(s)), noise.sigmas(s, **kw)
    if kind == "full":
        A = rng.normal(size=(K, r, r))
        cov = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(r)
        return jnoise.covariance(jnp.asarray(cov)), noise.covariance(cov, **kw)
    if kind == "constrained":
        s = rng.uniform(0.05, 2.0, size=(K, r))
        s[:, 1] = 0.0                      # a hard-constrained row
        return (jnoise.constrained_sigmas(jnp.asarray(s), 500.0),
                noise.constrained_sigmas(s, 500.0, **kw))
    base = rng.uniform(0.5, 2.0, size=(K, r))
    return (jnoise.robust(jnoise.precisions(jnp.asarray(base)), "huber", 1.2),
            noise.robust(noise.precisions(base, **kw), "huber", 1.2))


@pytest.mark.parametrize("kind", ["unit", "diag", "full", "constrained",
                                  "huber"])
def test_whiten_system_and_error(kind):
    rng = np.random.default_rng(3)
    K, r = 17, 3
    jn, pn = _noise_pairs(kind, K, r, rng)
    res = 2.0 * rng.normal(size=(K, r))
    Js = (rng.normal(size=(K, r, 3)), rng.normal(size=(K, r, 2)))
    jrw, jJw = jnoise.whiten_system(jn, jnp.asarray(res),
                                    tuple(map(jnp.asarray, Js)))
    rw, Jw = noise.whiten_system(pn, torch.tensor(res),
                                 tuple(map(torch.tensor, Js)))
    _close(rw, jrw, rtol=1e-12)
    for a, b in zip(Jw, jJw):
        _close(a, b, rtol=1e-12)
    _close(noise.whiten_residual(pn, torch.tensor(res)),
           jnoise.whiten_residual(jn, jnp.asarray(res)), rtol=1e-12)
    _close(noise.error(pn, torch.tensor(res)),
           jnoise.error(jn, jnp.asarray(res)), rtol=1e-12)
    assert noise.log_det_whitener(pn) == pytest.approx(
        jnoise.log_det_whitener(jn), rel=1e-12, abs=1e-12)


def test_noise_factories():
    kw = dict(device="cpu", dtype=F64)
    rng = np.random.default_rng(4)
    A = rng.normal(size=(3, 3))
    info = A @ A.T + np.eye(3)
    _close(noise.information(info, **kw).data,
           jnoise.information(jnp.asarray(info)).data, rtol=1e-12)
    _close(noise.sqrt_information(A, **kw).data, A)
    _close(noise.isotropic(3, 0.2, **kw).data,
           jnoise.isotropic(3, 0.2).data, rtol=1e-15)
    _close(noise.constrained_all(3, **kw).data,
           jnoise.constrained_all(3).data)
    assert noise.constrained_all(3, **kw).kind == "constrained"


# --- linearization ----------------------------------------------------------

@pytest.mark.parametrize("which", CASES)
def test_linearize_matches(cases, which):
    c = cases[which]
    assert len(c.lin.batches) == len(c.jlin.batches)
    for b, jb in zip(c.lin.batches, c.jlin.batches):
        assert b.groups == jb.groups and b.sign == jb.sign
        np.testing.assert_array_equal(b.idx.numpy(), np.asarray(jb.idx))
        # entries of J that are structurally zero come out as rounding
        # noise (~1e-17) in one package and as 0 in the other
        _close(b.r, jb.r, atol=1e-13)
        for J, jJ in zip(b.Js, jb.Js):
            assert J.shape == tuple(jJ.shape)
            _close(J, jJ, atol=1e-13)


@pytest.mark.parametrize("which", CASES)
def test_gaussian_graph_methods(cases, which):
    c = cases[which]
    g = next(iter(c.values.blocks))
    rng = np.random.default_rng(5)
    x = rng.normal(size=tuple(c.values.zero_tangent()[g].shape))
    ref = jax.jit(lambda lin, d: (
        lin.error_at_zero(), lin.gradient_at_zero(),
        lin.hessian_vector_product(d), lin.hessian_diagonal(),
        lin.hessian_block_diagonal()))(c.jlin, {g: jnp.asarray(x)})
    _close(c.lin.error_at_zero(), ref[0])
    _close(c.lin.gradient_at_zero()[g], ref[1][g], atol=1e-9)
    _close(c.lin.hessian_vector_product({g: torch.tensor(x)})[g], ref[2][g],
           atol=1e-9)
    _close(c.lin.hessian_diagonal()[g], ref[3][g])
    _close(c.lin.hessian_block_diagonal()[g], ref[4][g], atol=1e-9)
    H, gv = c.lin.assemble_dense(c.layout)
    jH, jgv = j_assemble(c.jlin, c.jlayout)
    _close(H, jH, atol=1e-9)
    _close(gv, jgv, atol=1e-9)
    # H is what the matvec applies
    _close(H @ torch.tensor(x).reshape(-1),
           c.layout.flatten(c.lin.hessian_vector_product(
               {g: torch.tensor(x)})).numpy(), rtol=1e-9, atol=1e-7)


def test_linearize_user_residual_with_single_element_signature():
    """A user's residual function, written for ONE factor with Python
    indexing as the JAX package's users write it, linearizes under
    vmap + jacfwd."""
    def jres(xs, meas):
        pose, point = xs
        return jse2.transform_to(pose, point) - meas["measured"]

    def res(xs, meas):
        from gtsam_personal_tpu_torch.geometry import se2
        pose, point = xs
        return se2.transform_to(pose, point) - meas["measured"]

    rng = np.random.default_rng(6)
    K = 9
    poses = rng.normal(size=(4, 3))
    pts = 3.0 * rng.normal(size=(5, 2))
    idx = np.stack([rng.integers(4, size=K), rng.integers(5, size=K)], 1)
    z = rng.normal(size=(K, 2))
    s = rng.uniform(0.1, 1.0, size=(K, 2))
    jb = jgraph_mod.FactorBatch(
        "pose_point", jres, ("se2", "point2"), 2, jnp.asarray(idx),
        {"measured": jnp.asarray(z)}, jnoise.sigmas(jnp.asarray(s)))
    pb = graph_mod.FactorBatch(
        "pose_point", res, ("se2", "point2"), 2, torch.tensor(idx),
        {"measured": torch.tensor(z)},
        noise.sigmas(s, device="cpu", dtype=F64))
    jv = jvalues_mod.Values({"se2": jnp.asarray(poses),
                             "point2": jnp.asarray(pts)})
    pv = values_mod.Values({"se2": torch.tensor(poses),
                            "point2": torch.tensor(pts)})
    jl, pl = j_linearize_batch(jb, jv), lin_mod.linearize_batch(pb, pv)
    _close(pl.r, jl.r)
    for J, jJ in zip(pl.Js, jl.Js):
        _close(J, jJ, atol=1e-14)
    g = lin_mod.GaussianGraph([pl], pv.counts())
    jg = jlin.GaussianGraph([jl], jv.counts())
    H, _ = g.assemble_dense(values_mod.Layout.of(pv))
    jH, _ = j_assemble(jg, jvalues_mod.Layout.of(jv))
    _close(H, jH, atol=1e-10)


@pytest.mark.parametrize("which", CASES)
def test_linearize_float32_stays_float32(cases, which):
    """A float32 graph linearizes to float32 blocks (forward-mode tangents
    of 0-dim tensors would otherwise come back as float64, and SE(3)'s
    matrix products would refuse them). They agree with the float64 blocks
    to 1e-3 of the largest entry, no closer: (1 - cos w) / w, which both
    packages use above w^2 = 1e-10, cancels to ~1e-3 relative in float32 at
    the residual angles of ~1e-2 that these graphs have."""
    c = cases[which]
    lin32 = lin_mod.linearize(port_graph(c.jgraph, torch.float32),
                              port_values(c.jvalues, torch.float32))
    for b32, b64 in zip(lin32.batches, c.lin.batches):
        assert b32.r.dtype == torch.float32
        np.testing.assert_allclose(b32.r.numpy(), b64.r.numpy(), rtol=0,
                                   atol=1e-3 * float(b64.r.abs().max()))
        for J32, J64 in zip(b32.Js, b64.Js):
            assert J32.dtype == torch.float32
            np.testing.assert_allclose(J32.numpy(), J64.numpy(), rtol=0,
                                       atol=1e-3 * float(J64.abs().max()))
