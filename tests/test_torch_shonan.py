"""The port's Shonan averaging (sfm/shonan.py) and its tool
(tools/shonan_averaging_cli.py) against the JAX package, in float64 on the
CPU.

The problems are tests/test_shonan_gnc.py's: `make_rotation_problem` and
the 12-node graph of its power-method test. `min_eigenvalue` starts from
`jax.random.normal(PRNGKey(0))` in the JAX package, which torch cannot
draw: that draw is passed to the port as `v0`. The levels' LM runs PCG
(cap 400, tolerance 1e-8), which converges inside its cap on these
problems."""

import contextlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.geometry import so3 as jso3
from gtsam_personal_tpu.linear import linearize as jlin
from gtsam_personal_tpu.sfm import shonan as jshonan
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import Values, values_from_numpy
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.sfm import shonan
from gtsam_personal_tpu_torch.slam import dataset, factors as F
from gtsam_personal_tpu_torch.tools import shonan_averaging_cli as cli
from test_shonan_gnc import make_rotation_problem

F64 = torch.float64
P_GRAPH = 4


@pytest.fixture
def fixed_eigsh_start(monkeypatch):
    """scipy's eigsh without v0 starts ARPACK from a hidden seed that moves
    on with every call in the process, so `_chordal_rotations` (both
    packages' copy) gives another sign of its eigenvectors, and with a
    reflection another start, from call to call (ROADMAP queue 3 C11).
    This fixes the start vector of every eigsh call to ones."""
    import scipy.sparse.linalg as spla
    eigsh = spla.eigsh
    monkeypatch.setattr(spla, "eigsh", lambda L, **kw: eigsh(
        L, v0=np.ones(L.shape[0]), **kw))


def jax_v0(n, seed=0):
    """The JAX package's start vector of min_eigenvalue, unnormalized."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, 3),
                                        dtype=jnp.float64))


def twelve_node_problem():
    """test_shonan_gnc.py's power-method problem: a 12-cycle and 4 chords,
    exact measurements, Y the true rotations transposed."""
    rng = np.random.default_rng(4)
    n = 12
    Rg = [np.asarray(jso3.expmap(jnp.asarray(rng.normal(scale=0.8,
                                                         size=3))))
          for _ in range(n)]
    edges, R_meas = [], []
    for i in range(n):
        jj = (i + 1) % n
        edges.append((i, jj))
        R_meas.append(Rg[i].T @ Rg[jj])
    for _ in range(4):
        i, jj = rng.choice(n, size=2, replace=False)
        edges.append((i, jj))
        R_meas.append(Rg[i].T @ Rg[jj])
    edges = np.asarray(edges)
    return edges, np.stack(R_meas), np.ones(len(edges)), \
        np.swapaxes(np.stack(Rg), 1, 2)


def dense_min_eig(edges, R_meas, kappa, Y):
    """lambda_min of the dense certificate matrix S = L - blockdiag(Lam)."""
    n = Y.shape[0]
    Z = np.swapaxes(Y, 1, 2)
    L = np.zeros((3 * n, 3 * n))
    for (i, jj), R, k in zip(edges, R_meas, kappa):
        L[3*i:3*i+3, 3*i:3*i+3] += k * np.eye(3)
        L[3*jj:3*jj+3, 3*jj:3*jj+3] += k * np.eye(3)
        L[3*i:3*i+3, 3*jj:3*jj+3] -= k * R
        L[3*jj:3*jj+3, 3*i:3*i+3] -= k * R.T
    Lam = np.einsum("nip,njp->nij", (L @ Z.reshape(3 * n, -1)).reshape(
        n, 3, -1), Z)
    Lam = 0.5 * (Lam + np.swapaxes(Lam, 1, 2))
    S = L.copy()
    for i in range(n):
        S[3*i:3*i+3, 3*i:3*i+3] -= Lam[i]
    return np.linalg.eigvalsh(S).min()


@pytest.fixture(scope="module")
def twelve():
    return twelve_node_problem()


def test_build_graph_at_linearizes_as_jax():
    """build_graph_at's residuals and Jacobians (through the sop<p> Cayley
    retraction) at a random lifted point, every batch, to 1e-12."""
    _, edges, meas = make_rotation_problem(8, noise=0.01)
    rng = np.random.default_rng(11)
    Y = np.stack([np.linalg.qr(rng.normal(size=(P_GRAPH, P_GRAPH)))[0]
                  for _ in range(8)])
    Y[:, :, -1] *= np.sign(np.linalg.det(Y))[:, None]
    kappa = rng.uniform(0.5, 2.0, size=len(edges))
    jg = jshonan.build_graph_at(P_GRAPH, edges, meas, kappa)
    g = shonan.build_graph_at(P_GRAPH, edges, meas, kappa, device="cpu",
                              dtype=F64)
    name = f"sop{P_GRAPH}"
    jl = jax.jit(jlin.linearize)(jg, JValues({name: jnp.asarray(Y)}))
    lin = linearize(g, Values({name: torch.tensor(Y)}))
    assert [b.groups for b in lin.batches] == [b.groups for b in jl.batches]
    for b, jb in zip(lin.batches, jl.batches):
        np.testing.assert_array_equal(b.idx.numpy(), np.asarray(jb.idx))
        np.testing.assert_allclose(b.r.numpy(), np.asarray(jb.r), rtol=0,
                                   atol=1e-12)
        for J, jJ in zip(b.Js, jb.Js):
            np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=0,
                                       atol=1e-12)
    err = float(g.error(Values({name: torch.tensor(Y)})))
    jerr = float(jg.error(JValues({name: jnp.asarray(Y)})))
    np.testing.assert_allclose(err, jerr, rtol=1e-13)


def test_connection_laplacian_matvec(twelve):
    edges, R_meas, kappa, Y = twelve
    V = np.random.default_rng(5).normal(size=(12, 3, 4))
    kap = np.random.default_rng(6).uniform(0.5, 2.0, size=len(edges))
    got = shonan._connection_laplacian_matvec(
        torch.tensor(edges), torch.tensor(R_meas), torch.tensor(kap),
        torch.tensor(V)).numpy()
    want = np.asarray(jshonan._connection_laplacian_matvec(
        jnp.asarray(edges), jnp.asarray(R_meas), jnp.asarray(kap),
        jnp.asarray(V)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("accelerated,iters", [(True, 300), (False, 2000)])
def test_min_eigenvalue_matches(twelve, accelerated, iters):
    """The accelerated and the plain power method from the JAX package's
    start vector: lambda_min to 1e-8 of the JAX package's, the iterate to
    1e-6, and lambda_min against a dense eig as the JAX test holds it."""
    edges, R_meas, kappa, Y = twelve
    lam, v = shonan.min_eigenvalue(edges, R_meas, kappa, Y, iters=iters,
                                   accelerated=accelerated, v0=jax_v0(12),
                                   device="cpu")
    jlam, jv = jshonan.min_eigenvalue(edges, R_meas, kappa, Y, iters=iters,
                                      accelerated=accelerated)
    assert abs(lam - jlam) <= 1e-8, (lam, jlam)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(lam, dense_min_eig(edges, R_meas, kappa, Y),
                               atol=1e-4 if accelerated else 1e-3)


def test_min_eigenvalue_default_start(twelve):
    """Without v0 the start is a torch.Generator draw from `seed`: another
    start, the same eigenvalue (dense eig, the JAX test's tolerance)."""
    edges, R_meas, kappa, Y = twelve
    lam, _ = shonan.min_eigenvalue(edges, R_meas, kappa, Y, iters=300,
                                   device="cpu")
    lam2, _ = shonan.min_eigenvalue(edges, R_meas, kappa, Y, iters=300,
                                    device="cpu")
    assert lam == lam2
    np.testing.assert_allclose(lam, dense_min_eig(edges, R_meas, kappa, Y),
                               atol=1e-4)


def test_chordal_rotations_match(fixed_eigsh_start):
    """The chordal start from the same eigsh start vector: the JAX
    package's to 1e-9, and every block a rotation."""
    _, edges, meas = make_rotation_problem(8, noise=0.01)
    got = shonan._chordal_rotations(edges, meas, 8)
    np.testing.assert_allclose(got, jshonan._chordal_rotations(edges, meas,
                                                               8), atol=1e-9)
    np.testing.assert_allclose(np.einsum("nab,ncb->nac", got, got),
                               np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-12)


@pytest.mark.parametrize("noise,p_max,seed", [
    (0.0, 5, 0), (0.01, 6, 0), (0.5, 6, 0)])
def test_shonan_averaging_matches(noise, p_max, seed):
    """The staircase on make_rotation_problem(8): test_shonan_gnc.py's two
    cases (certified at once), and a noisy one that climbs to p_max
    uncertified (every lift, descent and projection taken), from one
    chordal start given to both packages (ROADMAP queue 3 C11). Same
    certified and p_final, rotations and min_eig to 1e-6, cost to 1e-9
    relative."""
    truth, edges, meas = make_rotation_problem(8, noise=noise, seed=seed)
    init = shonan._chordal_rotations(edges, meas, 8)
    jres = jshonan.shonan_averaging(edges, meas, p_min=3, p_max=p_max,
                                    init=init)
    levels = []
    res = shonan.shonan_averaging(edges, meas, p_min=3, p_max=p_max,
                                  init=init, v0=jax_v0(8), device="cpu",
                                  on_level=levels.append)
    assert (res.certified, res.p_final) == (jres.certified, jres.p_final)
    assert [lv["p"] for lv in levels] == list(range(3, res.p_final + 1))
    np.testing.assert_allclose(res.rotations, jres.rotations, rtol=0,
                               atol=1e-6)
    assert abs(res.min_eig - jres.min_eig) <= 1e-6
    np.testing.assert_allclose(res.cost, jres.cost, rtol=1e-9, atol=1e-15)
    if noise == 0.0:
        anchored = np.einsum("ab,nbc->nac", truth[0].T, truth)
        assert np.abs(res.rotations - anchored).max() < 1e-4
    if noise == 0.01:
        assert res.certified and res.cost < 0.02


def _write_pose3_file(path, n=20, seed=3):
    """A 20-pose 3D graph, odometry and every 4th pose closed to the one 5
    before, rotation noise 0.01 rad an edge, through write_g2o_3d."""
    rng = np.random.default_rng(seed)
    from gtsam_personal_tpu_torch.geometry import se3
    xi = np.concatenate([rng.normal(scale=0.4, size=(n, 3)),
                         rng.normal(scale=1.0, size=(n, 3))], 1)
    truth = [np.eye(4)[:3]]
    for k in range(1, n):
        truth.append(se3.compose(torch.tensor(truth[-1]), se3.expmap(
            torch.tensor(xi[k]))).numpy())
    truth = np.stack(truth)
    edges = [(k, k + 1) for k in range(n - 1)] + [
        (k, k - 5) for k in range(5, n, 4)]
    gb = GraphBuilder()
    for i, j in edges:
        m = se3.compose(se3.between(torch.tensor(truth[i]),
                                    torch.tensor(truth[j])),
                        se3.expmap(torch.tensor(np.r_[rng.normal(
                            scale=0.01, size=3), np.zeros(3)]))).numpy()
        F.add_between(gb, "se3", i, j, m, F.diag_noise([0.01] * 3 +
                                                       [0.05] * 3))
    dataset.write_g2o_3d(path, values_from_numpy({"se3": truth},
                                                  device="cpu", dtype=F64),
                         gb.build(device="cpu", dtype=F64), fmt="quat")
    return len(edges)


def _parse(line):
    """certified, p, min_eig and cost from the result line."""
    head, rest = line.split(" at p=")
    p, rest = rest.split(", min_eig=")
    me, cost = rest.split(", cost=")
    return head == "certified=True", int(p), float(me), float(cost)


def test_cli_matches_jax_example(tmp_path, fixed_eigsh_start):
    """The tool's two lines against examples/shonan_averaging_cli.py's on
    a file that write_g2o_3d writes: the counts exactly, certified and p
    exactly, min_eig to 1e-6 and the cost to 1e-9 relative (their printed
    digits)."""
    path = str(tmp_path / "pose3_20.g2o")
    K = _write_pose3_file(path)
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["shonan_averaging_cli.py", path]
    try:
        with contextlib.redirect_stdout(out):
            import runpy
            runpy.run_path("examples/shonan_averaging_cli.py",
                           run_name="__main__")
    finally:
        sys.argv = argv
    jlines = out.getvalue().strip().splitlines()
    lines, notes = [], []
    rec = cli.run(path, device="cpu", v0=jax_v0(20), say=lines.append,
                  note=notes.append)
    assert lines[0] == jlines[0] == f"20 rotations, {K} measurements"
    got, want = _parse(lines[1]), _parse(jlines[1])
    assert got[:2] == want[:2] == (True, 3)
    assert abs(got[2] - want[2]) <= 1e-6
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    res = rec["result"]
    assert len(rec["levels"]) == 1 and rec["levels"][0]["pcg"]
    assert max(rec["levels"][0]["pcg"]) < 400   # PCG inside its cap
    jres = jshonan.shonan_averaging(rec["edges"], rec["R_meas"], p_min=3,
                                    p_max=7, init=rec["chordal"])
    np.testing.assert_allclose(res.cost, jres.cost, rtol=1e-9)
    np.testing.assert_allclose(res.rotations, jres.rotations, atol=1e-6)


def test_chordal_start_fixed_and_good():
    """chordal_start (the opt-in start without the reference's faults) is
    the same every call, within 0.05 rad of the truth in the gauge R_0 = I,
    and the JAX package's staircase from it certifies at p = 3 with the
    port's, rotations to 1e-6."""
    truth, edges, meas = make_rotation_problem(8, noise=0.01)
    a = shonan.chordal_start(edges, meas, 8)
    b = shonan.chordal_start(edges, meas, 8)
    np.testing.assert_array_equal(a, b)
    rel = np.einsum("ba,nbc->nac", a[0], a)
    want = np.einsum("ba,nbc->nac", truth[0], truth)
    cos = (np.einsum("nab,nab->n", rel, want) - 1) / 2
    assert np.arccos(np.clip(cos, -1, 1)).max() < 0.05
    res = shonan.shonan_averaging(edges, meas, p_max=6, init=a,
                                  v0=jax_v0(8), device="cpu")
    jres = jshonan.shonan_averaging(edges, meas, p_max=6, init=a)
    assert res.certified and jres.certified and res.p_final == 3
    np.testing.assert_allclose(res.rotations, jres.rotations, atol=1e-6)
