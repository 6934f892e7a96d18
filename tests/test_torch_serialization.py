"""The port's utils/serialization.py: files of the JAX package read into the
port, the port's own round trips, the refusal of unknown residuals and of
pickle, and ISAM2 saved mid-stream and resumed, float64 on the CPU.

The resumed ISAM2 stream is held to the uninterrupted port engine to 1e-12
and to the JAX engine fed the same arrays to 1e-9, with the CG run to
convergence (tolerance 1e-10, a cap it does not reach), as
tests/test_torch_isam2.py does."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core.graph import GraphBuilder as JGraphBuilder
from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.linear import noise as jnz
from gtsam_personal_tpu.nonlinear import isam2 as jisam
from gtsam_personal_tpu.slam import factors as JF, manhattan as jmanhattan
from gtsam_personal_tpu.utils import serialization as jser
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.linear import noise as tnz
from gtsam_personal_tpu_torch.nonlinear import isam2 as tisam, optimizers
from gtsam_personal_tpu_torch.slam import factors as F, manhattan
from gtsam_personal_tpu_torch.utils import serialization as ser

F64 = torch.float64


def _jax_graph():
    """A JAX graph of three factor types: the Manhattan world's prior and
    between factors (closures of factories) and one projection factor (a
    module-level residual)."""
    jg, jv, _ = jmanhattan.make_manhattan(40, seed=2)
    b = JGraphBuilder()
    b.add("proj", JF.projection_residual, ("se3", "point3"), 2, [0, 0],
          {"measured": np.array([320.0, 240.0]),
           "cal": np.array([500.0, 500.0, 0.0, 320.0, 240.0])},
          {"kind": "diag", "data": np.array([1.0, 2.0])})
    extra = b.build(dtype=jnp.float64)
    batches = jg.batches + extra.batches
    jg = type(jg)(batches)
    jv = JValues(dict(jv.blocks, se3=jnp.eye(3, 4, dtype=jnp.float64)[None],
                      point3=jnp.array([[0.1, -0.2, 5.0]])))
    return jg, jv


def test_jax_written_files_load_into_the_port(tmp_path):
    jg, jv = _jax_graph()
    jser.save_graph(str(tmp_path / "g.npz"), jg)
    jser.save_values(str(tmp_path / "v.npz"), jv)
    jser.save_lm_carry(str(tmp_path / "c.npz"), jv, jnp.asarray(1e-3),
                       jnp.asarray(7.5))
    g = ser.load_graph(str(tmp_path / "g.npz"), device="cpu", dtype=None)
    v = ser.load_values(str(tmp_path / "v.npz"), device="cpu", dtype=None)
    for jb, b in zip(jg.batches, g.batches):
        assert (jb.name, tuple(jb.groups)) == (b.name, b.groups)
        np.testing.assert_array_equal(b.idx.numpy(), np.asarray(jb.idx))
        for k in jb.meas:
            np.testing.assert_array_equal(b.meas[k].numpy(),
                                          np.asarray(jb.meas[k]))
    for grp in jv.blocks:
        np.testing.assert_array_equal(v[grp].numpy(), np.asarray(jv[grp]))
    np.testing.assert_allclose(float(g.error(v)), float(jg.error(jv)),
                               rtol=1e-12)
    cv, lam, err = ser.load_lm_carry(str(tmp_path / "c.npz"), device="cpu",
                                     dtype=F64)
    assert (float(lam), float(err)) == (1e-3, 7.5)
    assert sorted(cv.blocks) == sorted(jv.blocks)


def _port_graph():
    g, v, _ = manhattan.make_manhattan(30, seed=4, device="cpu", dtype=F64)
    b = GraphBuilder()
    b.add("stereo", F.stereo_residual, ("se3", "point3"), 3, [0, 0],
          {"measured": np.array([330.0, 310.0, 250.0]),
           "cal": np.array([500.0, 500.0, 320.0, 240.0, 0.1])},
          {"kind": "unit"})
    b.add("between_em_se3", F.residual_by_name("between_em_se3"),
          ("se3", "se3"), 12, [0, 0],
          {"measured": np.eye(3, 4), "w_in": np.full(6, 10.0),
           "w_out": np.full(6, 0.1), "prior_in": 0.9, "prior_out": 0.1},
          {"kind": "unit"})
    graph = type(g)(g.batches + b.build(device="cpu", dtype=F64).batches)
    values = v.with_block("se3", torch.eye(3, 4, dtype=F64)[None])
    values = values.with_block("point3", torch.tensor([[0.2, 0.1, 4.0]],
                                                      dtype=F64))
    return graph, values.with_block("__odd", torch.arange(6.0).reshape(3, 2))


def test_port_round_trips_are_exact(tmp_path):
    g, v = _port_graph()
    ser.save_graph(str(tmp_path / "g.npz"), g)
    ser.save_values(str(tmp_path / "v.npz"), v)
    ser.save_lm_carry(str(tmp_path / "c.npz"), v, torch.tensor(
        1e-3, dtype=torch.float32), torch.tensor(3.25, dtype=torch.float32))
    g2 = ser.load_graph(str(tmp_path / "g.npz"), device="cpu", dtype=None)
    v2 = ser.load_values(str(tmp_path / "v.npz"), device="cpu", dtype=None)
    assert sorted(v2.blocks) == sorted(v.blocks)      # "__odd" included
    for grp in v.blocks:
        assert torch.equal(v2[grp], v[grp])
    assert float(g2.error(v)) == float(g.error(v))
    for b, b2 in zip(g.batches, g2.batches):
        assert (b.name, b.groups, b.rdim, b.sign) == (b2.name, b2.groups,
                                                      b2.rdim, b2.sign)
    cv, lam, err = ser.load_lm_carry(str(tmp_path / "c.npz"), device="cpu",
                                     dtype=torch.float32)
    assert "__odd" in cv.blocks
    assert lam.item() == np.float32(1e-3) and err.item() == 3.25
    assert lam.dtype == torch.float32


def test_lm_run_resumes_exactly(tmp_path):
    """lm_run for 6 iterations == 3, save the carry, load, 3 more."""
    g, v, _ = manhattan.make_manhattan(60, seed=6, device="cpu", dtype=F64)
    params = optimizers.Params(solver="dense")
    err0 = optimizers.graph_error(g, v)
    full = optimizers.lm_run(g, v, 1e2, err0, 6, params)
    half = optimizers.lm_run(g, v, 1e2, err0, 3, params)
    ser.save_lm_carry(str(tmp_path / "c.npz"), *half)
    rest = optimizers.lm_run(g, *ser.load_lm_carry(
        str(tmp_path / "c.npz"), device="cpu", dtype=F64), 3, params)
    assert torch.equal(rest[0]["se2"], full[0]["se2"])
    assert float(rest[1]) == float(full[1]) and float(rest[2]) == float(
        full[2])


def test_unknown_residuals_raise_and_nothing_is_imported(tmp_path):
    """A file that names a residual neither registered nor known to
    residual_by_name raises; the module it names is never imported; a
    closure factory that held more than its groups raises ValueError; an
    archive that needs pickle is refused."""
    jg, _ = _jax_graph()
    jser.save_graph(str(tmp_path / "g.npz"), jg)
    head = tmp_path / "g.npz.json"
    header = json.loads(head.read_text())
    header[-1].update(name="mystery", residual_module="evil_module_xyz",
                      residual_qualname="mystery_residual")
    head.write_text(json.dumps(header))
    with pytest.raises(KeyError, match="register_residual"):
        ser.load_graph(str(tmp_path / "g.npz"), device="cpu", dtype=None)
    assert "evil_module_xyz" not in sys.modules
    ser.register_residual("mystery", F.projection_residual)
    try:
        g = ser.load_graph(str(tmp_path / "g.npz"), device="cpu", dtype=None)
        assert g.batches[-1].residual_fn is F.projection_residual
    finally:
        ser._REGISTRY.pop("mystery")
    with pytest.raises(ValueError, match="register_residual"):
        ser.resolve_residual("pp", ("se3",),
                             "make_partial_prior_residual.<locals>.residual")
    np.savez(str(tmp_path / "o.npz"), x=np.array([{}], dtype=object))
    with pytest.raises(ValueError):
        ser.load_values(str(tmp_path / "o.npz"), device="cpu", dtype=None)


# -- ISAM2 ---------------------------------------------------------------------

COMMON = dict(relinearize_threshold=0.02, cg_maxiter=400, cg_tol=1e-10,
              relin_chunk=64, min_fac_cap=128)
SIGMAS = np.array([0.05, 0.05, 0.01])


def _compose(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     a[2] + b[2]])


def _edges(n=36, seed=3):
    """A grid walk with odometry and closures every 7 poses."""
    rng = np.random.default_rng(seed)
    edges = []
    for k in range(1, n):
        edges.append((k - 1, k, np.array([1.0, 0.0, rng.choice(
            [0.0, np.pi / 2, -np.pi / 2], p=[0.8, 0.1, 0.1])])
            + rng.normal(0, [0.05, 0.05, 0.01])))
        if k % 7 == 0:
            edges.append((k - 7, k, rng.normal(0, 1.0, 3)))
    return edges


class _Feed:
    """Feeds the stream's measurements into engines, one update each."""

    def __init__(self, engines, jax_engine=None):
        self.engines, self.jax = engines, jax_engine
        self.inits = [np.zeros(3)]

    def start(self):
        w = 1.0 / np.array([1e-3, 1e-3, 1e-4])
        for e in self.engines:
            e.add_variable("se2", np.zeros(3))
            e.add_factor("prior_se2", F.make_prior_residual("se2"), ["se2"],
                         3, [0], {"prior": np.zeros(3)},
                         tnz.NoiseModel("diag", w))
            e.update()
        if self.jax:
            self.jax.add_variable("se2", np.zeros(3))
            self.jax.add_factor("prior_se2", JF.make_prior_residual("se2"),
                                ["se2"], 3, [0], {"prior": np.zeros(3)},
                                jnz.NoiseModel("diag", jnp.asarray(w)))
            self.jax.update()

    def feed(self, edges):
        for i, j, m in edges:
            if j == len(self.inits):
                self.inits.append(_compose(self.inits[i], m))
                for e in self.engines + ([self.jax] if self.jax else []):
                    e.add_variable("se2", self.inits[-1])
            for e in self.engines:
                e.add_factor("between_se2", F.make_between_residual("se2"),
                             ["se2", "se2"], 3, [i, j], {"measured": m},
                             tnz.NoiseModel("diag", 1.0 / SIGMAS))
                e.update()
            if self.jax:
                self.jax.add_factor(
                    "between_se2", JF.make_between_residual("se2"),
                    ["se2", "se2"], 3, [i, j], {"measured": m},
                    jnz.NoiseModel("diag", jnp.asarray(1.0 / SIGMAS)))
                self.jax.update()


@pytest.mark.parametrize("precond", ["jacobi", "chain:se2"])
def test_isam2_resumes_mid_stream(tmp_path, precond):
    edges = _edges()
    half = len(edges) // 2
    params = tisam.ISAM2Params(dtype=F64, precond=precond, **COMMON)
    whole, part = (tisam.ISAM2(params, device="cpu") for _ in range(2))
    j = (jisam.ISAM2(jisam.ISAM2Params(dtype=np.float64, precond=precond,
                                       **COMMON))
         if precond == "chain:se2" else None)
    run = _Feed([whole, part], j)
    run.start()
    run.feed(edges[:half])
    ser.save_isam2(str(tmp_path / "i.npz"), part)
    resumed = ser.load_isam2(str(tmp_path / "i.npz"), device="cpu")
    run.engines = [whole, resumed]
    run.feed(edges[half:])
    est, ref = resumed.estimate_array("se2"), whole.estimate_array("se2")
    np.testing.assert_allclose(est, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(resumed.error(), whole.error(), rtol=1e-12)
    if j is not None:
        np.testing.assert_allclose(est, j.estimate_array("se2"), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(resumed.error(), j.error(), rtol=1e-9)


def test_isam2_resumes_after_eviction(tmp_path):
    """An engine that marginalized poses holds a marginal factor: saved and
    loaded, its residual is rebuilt from its groups, and the stream goes on
    as in the engine that was never saved."""
    edges = [e for e in _edges() if e[1] - e[0] == 1]
    params = tisam.ISAM2Params(dtype=F64, precond="jacobi", **COMMON)
    whole, part = (tisam.ISAM2(params, device="cpu") for _ in range(2))
    run = _Feed([whole, part])
    run.start()
    run.feed(edges[:20])
    for e in (whole, part):
        e.marginalize_variables({"se2": list(range(8))})
        e.update()
    ser.save_isam2(str(tmp_path / "i.npz"), part)
    resumed = ser.load_isam2(str(tmp_path / "i.npz"), device="cpu")
    assert any(k[0].startswith("marginal") for k in resumed._batch_keys)
    run.engines = [whole, resumed]
    run.feed(edges[20:])
    np.testing.assert_allclose(resumed.estimate_array("se2")[8:],
                               whole.estimate_array("se2")[8:], rtol=0,
                               atol=1e-12)
