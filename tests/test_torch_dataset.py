"""The port's slam/dataset.py against the JAX package's, float64 on the CPU,
on files the tests write themselves.

Parsing is the same numpy code in both packages, so every array of the
graphs and values that the loaders build must be equal exactly; the writers
must write byte-identical text for the same float64 numbers."""

import numpy as np
import pytest
import torch

from gtsam_personal_tpu.slam import dataset as jds
from gtsam_personal_tpu_torch.geometry import se3
from gtsam_personal_tpu_torch.slam import dataset as ds

F64 = torch.float64
# six information values that are SPD read in either order (g2o's row-major
# upper triangle or TORO's ff fs ss rr fr sr) and as a covariance
INFO = [10.0, 0.1, 5.0, 30.0, 0.2, 8.0]


def _np(x):
    return None if x is None else np.asarray(x)


def assert_same_graph(jgraph, jvalues, graph, values):
    """Every array of the two graphs and values equal exactly."""
    assert [b.name for b in jgraph.batches] == [b.name for b in graph.batches]
    for jb, b in zip(jgraph.batches, graph.batches):
        assert tuple(jb.groups) == b.groups and jb.rdim == b.rdim
        np.testing.assert_array_equal(b.idx.numpy(), np.asarray(jb.idx))
        assert sorted(jb.meas) == sorted(b.meas)
        for k in jb.meas:
            np.testing.assert_array_equal(b.meas[k].numpy(),
                                          np.asarray(jb.meas[k]))
        assert jb.noise.kind == b.noise.kind
        np.testing.assert_array_equal(_np(b.noise.data),
                                      _np(jb.noise.data))
    assert sorted(jvalues.blocks) == sorted(values.blocks)
    for g in jvalues.blocks:
        np.testing.assert_array_equal(values[g].numpy(),
                                      np.asarray(jvalues[g]))


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _file_2d(tmp_path, info=INFO, vertices=True, landmarks=True):
    rng = np.random.default_rng(0)
    lines = []
    if vertices:
        for i, tag in enumerate(["VERTEX2", "VERTEX_SE2", "VERTEX",
                                 "VERTEX_SE2", "VERTEX_SE2"]):
            x, y, t = rng.normal(size=3)
            lines.append(f"{tag} {i} {x} {y} {t}")
    for i, (j, tag) in enumerate([(1, "EDGE2"), (2, "EDGE"), (3, "EDGE_SE2"),
                                  (4, "ODOMETRY")]):
        m = rng.normal(size=3)
        lines.append(f"{tag} {i} {j} {m[0]} {m[1]} {m[2]} "
                     + " ".join(map(str, info)))
    m = rng.normal(size=3)
    lines.append(f"EDGE_SE2 0 3 {m[0]} {m[1]} {m[2]} "
                 + " ".join(map(str, info)))
    if landmarks:
        lines += ["BR 0 100 0.3 4.0 0.05 0.1", "BR 2 7 -0.4 2.5 0.05 0.1",
                  "LANDMARK 3 100 1.0 2.0 0.5 0.0 0.5",
                  "LANDMARK 4 55 -1.0 0.5 0.5 0.0 0.7"]
    return _write(tmp_path / "g.graph", lines)


@pytest.mark.parametrize("fmt", ["g2o", "toro", "cov", "graph", "auto"])
def test_load_2d_every_tag_and_convention(tmp_path, fmt):
    path = _file_2d(tmp_path)
    jg, jv = jds.load_2d(path, noise_format=fmt, dtype=np.float64)
    g, v = ds.load_2d(path, noise_format=fmt, device="cpu", dtype=F64)
    assert_same_graph(jg, jv, g, v)
    assert "point2" in v.blocks and len(g.batches) == 3


@pytest.mark.parametrize("pattern", ["graph", "cov"])
def test_load_2d_auto_guess(tmp_path, pattern):
    """AUTO reads the zero pattern of the first edge's six values."""
    info = {"graph": [10.0, 0.0, 20.0, 30.0, 0.0, 0.0],
            "cov": [0.1, 0.0, 0.0, 0.2, 0.0, 0.3]}[pattern]
    path = _file_2d(tmp_path, info=info, landmarks=False)
    jg, jv = jds.load_2d(path, noise_format="auto", dtype=np.float64)
    g, v = ds.load_2d(path, noise_format="auto", device="cpu", dtype=F64)
    assert_same_graph(jg, jv, g, v)
    g2, _ = ds.load_2d(path, noise_format=pattern, device="cpu", dtype=F64)
    np.testing.assert_array_equal(g.batches[1].noise.data.numpy(),
                                  g2.batches[1].noise.data.numpy())


def test_load_2d_without_vertices_composes_odometry(tmp_path):
    path = _file_2d(tmp_path, vertices=False, landmarks=False)
    jg, jv = jds.load_2d(path, dtype=np.float64)
    g, v = ds.load_2d(path, device="cpu", dtype=F64)
    assert_same_graph(jg, jv, g, v)
    assert v["se2"].abs().sum() > 0


def _file_3d(tmp_path, n=6, vertex_tags=("VERTEX3", "VERTEX_SE3:QUAT"),
             drop_vertex=None):
    rng = np.random.default_rng(1)
    lines = []
    poses = se3.expmap(torch.tensor(rng.normal(size=(n, 6)))).numpy()
    for i in range(n):
        if i == drop_vertex:
            continue
        x, y, z = poses[i, :, 3]
        tag = vertex_tags[i % len(vertex_tags)]
        if tag == "VERTEX3":
            r, p, yw = ds.matrix_to_ypr(poses[i, :, :3])
            lines.append(f"VERTEX3 {i} {x} {y} {z} {r} {p} {yw}")
        else:
            q = ds.matrix_to_quat(poses[i, :, :3])
            lines.append(f"VERTEX_SE3:QUAT {i} {x} {y} {z} "
                         + " ".join(map(str, q)))
    A = rng.normal(size=(6, 6))
    info = (A @ A.T + 6 * np.eye(6))[np.triu_indices(6)]
    for i in range(n - 1):
        for j in ([i + 1] + ([0] if i == n - 2 else [])):
            rel = se3.between(torch.tensor(poses[i]),
                              torch.tensor(poses[j])).numpy()
            x, y, z = rel[:, 3] + 0.01 * rng.normal(size=3)
            if (i + j) % 2:
                r, p, yw = ds.matrix_to_ypr(rel[:, :3])
                lines.append(f"EDGE3 {i} {j} {x} {y} {z} {r} {p} {yw} "
                             + " ".join(map(str, info)))
            else:
                q = ds.matrix_to_quat(rel[:, :3])
                lines.append(f"EDGE_SE3:QUAT {i} {j} {x} {y} {z} "
                             + " ".join(map(str, q)) + " "
                             + " ".join(map(str, info)))
    return _write(tmp_path / "g3.g2o", lines)


@pytest.mark.parametrize("case", ["all_vertices", "compose", "vertices"])
def test_load_3d(tmp_path, case):
    """Every tag; the vertex rule of dataset.py:282 with all vertices, and
    with one missing under init='compose' and init='vertices'."""
    path = _file_3d(tmp_path, drop_vertex=None if case == "all_vertices"
                    else 3)
    init = "vertices" if case == "vertices" else "compose"
    jg, jv = jds.load_3d(path, dtype=np.float64, init=init)
    g, v = ds.load_3d(path, init=init, device="cpu", dtype=F64)
    assert_same_graph(jg, jv, g, v)


def _jax_writer_inputs(path, three_d):
    if three_d:
        return jds.load_3d(path, dtype=np.float64)
    return jds.load_2d(path, dtype=np.float64)


@pytest.mark.parametrize("kind", ["2d", "quat", "edge3"])
def test_writers_write_the_same_text(tmp_path, kind):
    three_d = kind != "2d"
    src = (_file_3d(tmp_path) if three_d
           else _file_2d(tmp_path, landmarks=False))
    jg, jv = _jax_writer_inputs(src, three_d)
    out_j, out_t = str(tmp_path / "j.g2o"), str(tmp_path / "t.g2o")
    if three_d:
        g, v = ds.load_3d(src, device="cpu", dtype=F64)
        jds.write_g2o_3d(out_j, jv, jg, fmt=kind)
        ds.write_g2o_3d(out_t, v, g, fmt=kind)
    else:
        g, v = ds.load_2d(src, device="cpu", dtype=F64)
        jds.write_g2o_2d(out_j, jv, jg)
        ds.write_g2o_2d(out_t, v, g)
    text = open(out_t).read()
    assert text == open(out_j).read()
    assert text.count("\n") == v[next(iter(v.blocks))].shape[0] + sum(
        b.size for b in g.batches if b.name.startswith("between"))


@pytest.mark.parametrize("kind", ["2d", "quat"])
def test_round_trip(tmp_path, kind):
    """Write, read back: the measurements and values come back as the
    decimal text carries them (repr of a float64 is exact), the
    information to rounding, so the error at the same values agrees."""
    three_d = kind != "2d"
    src = (_file_3d(tmp_path) if three_d
           else _file_2d(tmp_path, landmarks=False))
    load = ds.load_3d if three_d else ds.load_2d
    write = ((lambda p, v, g: ds.write_g2o_3d(p, v, g, fmt="quat"))
             if three_d else ds.write_g2o_2d)
    g, v = load(src, device="cpu", dtype=F64)
    out = str(tmp_path / "rt.g2o")
    write(out, v, g)
    g2, v2 = load(out, device="cpu", dtype=F64)
    grp = "se3" if three_d else "se2"
    if three_d:   # quaternion text: the rotation to rounding
        np.testing.assert_allclose(v2[grp].numpy(), v[grp].numpy(),
                                   rtol=0, atol=1e-15)
    else:
        np.testing.assert_array_equal(v2[grp].numpy(), v[grp].numpy())
    np.testing.assert_allclose(float(g2.error(v)), float(g.error(v)),
                               rtol=1e-12)


def test_float32_writer_writes_float64_text(tmp_path):
    """A float32 graph is written from its float64 values: the text is the
    float64 one of the same numbers."""
    src = _file_2d(tmp_path, landmarks=False)
    g32, v32 = ds.load_2d(src, device="cpu", dtype=torch.float32)
    out = tmp_path / "f32.g2o"
    ds.write_g2o_2d(str(out), v32, g32)
    first = out.read_text().splitlines()[0].split()
    assert float(first[2]) == float(np.float64(v32["se2"][0, 0].item()))


def test_find_example_data(tmp_path, monkeypatch):
    """The JAX package's search order; the reference's data directory comes
    from GTSAM_EXAMPLE_DATA_DIR."""
    with pytest.raises(FileNotFoundError):
        ds.find_example_data("no_such_dataset.g2o")
    with pytest.raises(FileNotFoundError):
        jds.find_example_data("no_such_dataset.g2o")
    (tmp_path / "w.graph").write_text("")
    monkeypatch.setattr(ds, "REFERENCE_DATA_DIR", str(tmp_path))
    assert ds.find_example_data("w.graph") == str(tmp_path / "w.graph")
