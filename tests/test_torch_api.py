"""The port's DexNet facade, its interactive CLI, the URDF writer, the image
converter, the plots and the diagnostic tools against the JAX package.

Small sizes throughout: the octahedral sphere of ``tests/test_api.py``
(128 triangles, radius 5 cm) at sdf_dim 32, 1-2 grasps per class.

- ``DexNet``: the JAX package's facade runs in float32 (x64 off, as its own
  runtime), the port's on the CPU. ``add_object`` gives the SDF of the
  voxelizer tests (rtol 1e-5 / atol 1e-7, ``test_torch_voxelizer``) and
  equal stable poses. Sampling and labeling then run on one grid (JAX's,
  stored into the port's database). ``sample_grasps`` with the port's own
  sampler under JAX's draws: each round lane by lane against JAX's under
  the rounding rule of ``test_torch_labeling_samplers``, and the packed
  rows as JAX's facade packs those rounds. Then JAX's antipodal rounds are
  replayed into the port (``_Replay``: float32 leaves some of the
  sampler's lanes to rounding, which would shift every later packed row):
  the port's sampled configs equal JAX's, and its labeled rows meet that
  file's ``_assert_rows`` with JAX's force-only metric swapped for the
  float64 witness (``exact_jax_canny``). Every replayed round checks that
  the port asked for it with the JAX draws of the same round, so the
  draws' plumbing is held too.
- The scripted CLI session prints the same lines as JAX's, apart from
  paths, and leaves the same database under the same rule.
- ``UrdfWriter.write`` writes JAX's URDF and piece files; an error of the
  voxelizer propagates (the JAX package falls back to the hull there).
"""

import importlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnetgpd_tpu import api as japi
from pointnetgpd_tpu.cli import dexnet_cli as jcli
from pointnetgpd_tpu.cli import tools as jtools
from pointnetgpd_tpu.geometry import image_converter as jimc
from pointnetgpd_tpu.geometry import sdf as jsdf
from pointnetgpd_tpu.geometry import urdf_writer as jurdf
from pointnetgpd_tpu.geometry.io import write_obj as jwrite_obj
from pointnetgpd_tpu.geometry.io import write_sdf as jwrite_sdf
from pointnetgpd_tpu.geometry.mesh import Mesh3D as JMesh3D
from pointnetgpd_tpu.grasping import grasp as jg
from pointnetgpd_tpu.grasping import samplers as js
from pointnetgpd_tpu.pipelines import generate_dataset as jgen
from pointnetgpd_tpu.visualization import plots as jplots
from pointnetgpd_tpu_torch import api as tapi
from pointnetgpd_tpu_torch.cli import dexnet_cli as tcli
from pointnetgpd_tpu_torch.cli import tools as ttools
from pointnetgpd_tpu_torch.geometry import image_converter as timc
from pointnetgpd_tpu_torch.geometry import sdf as tsdf
from pointnetgpd_tpu_torch.geometry import urdf_writer as turdf
from pointnetgpd_tpu_torch.geometry.mesh import Mesh3D
from pointnetgpd_tpu_torch.grasping import samplers as ts
from pointnetgpd_tpu_torch.grasping.gripper import Gripper
from pointnetgpd_tpu_torch.ops import point_triangle as k3
from pointnetgpd_tpu_torch.pipelines import generate_dataset as tgen
from pointnetgpd_tpu_torch.visualization import plots as tplots

from test_torch_labeling import (_assert_points, _n, _t, ellipsoid_data,
                                 exact_jax_canny)
from test_torch_labeling_samplers import (LabelJaxDraws, _assert_rows,
                                          _assert_sampled, _nudged, _unstable)
from test_torch_voxelizer import assert_sdf_equal, box

jcloud = importlib.import_module("pointnetgpd_tpu.ops.cloud")

CONFIG = {"sdf_dim": 32, "sdf_padding": 3, "grasps_per_class": 2,
          "obj_rescaling_type": "relative"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _f32_jax():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def jax_canny64():
    """JAX's force-only metric swapped for the float64 witness, entered once
    for the module: ``exact_jax_canny`` clears JAX's jit caches on entry and
    exit, so the lifecycle and the CLI session share one compile of JAX's
    labeling programs."""
    with exact_jax_canny():
        yield


@pytest.fixture()
def sphere_obj(tmp_path):
    """The octahedral sphere of tests/test_api.py, as an OBJ file."""
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], float)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    m = JMesh3D(v, f).subdivide().subdivide()
    path = str(tmp_path / "sphere.obj")
    jwrite_obj(path, 0.05 * m.vertices / np.linalg.norm(
        m.vertices, axis=1, keepdims=True), m.triangles)
    return path


class _Replay:
    """JAX's antipodal rounds, replayed into the port. Each port round
    must come with the JAX draws of the same round and the same sampler
    arguments."""

    def __init__(self, monkeypatch, *modules):
        self.rounds = []
        self.sample = js.antipodal_sample_grasps
        self.torch_sample = ts.antipodal_sample_grasps
        for jmod, tmod in modules:
            monkeypatch.setattr(jmod, "antipodal_sample_grasps", self.jax_fn)
            monkeypatch.setattr(tmod, "antipodal_sample_grasps",
                                self.torch_fn)

    def jax_fn(self, sdf, key, **kw):
        out = self.sample(sdf, key, **kw)
        self.rounds.append((key, kw, out))
        return out

    def torch_fn(self, sdf, draws, **kw):
        key, jkw, out = self.rounds.pop(0)
        assert np.array_equal(jax.random.key_data(draws.key),
                              jax.random.key_data(key))
        assert kw == jkw
        return ts.SampledGrasps(*(_t(np.asarray(f)) for f in out))


def _facades(tmp_path, **cfg):
    j = japi.DexNet({**CONFIG, **cfg, "cache_dir": str(tmp_path / "jc")})
    t = tapi.DexNet({**CONFIG, **cfg, "cache_dir": str(tmp_path / "tc")},
                    device="cpu")
    for api, name in ((j, "j"), (t, "t")):
        api.open_database(str(tmp_path / f"{name}.hdf5"))
        api.open_dataset("test")
    return j, t


def _rows(api, key):
    configs, metrics = api.get_grasps(key)
    return np.concatenate([configs, metrics["friction"][:, None],
                           metrics["robust_ferrari_canny"][:, None]], 1)


def test_dexnet_lifecycle_matches_jax(tmp_path, sphere_obj, monkeypatch,
                                     jax_canny64):
    j, t = _facades(tmp_path)
    assert t.device == "cpu" and tapi.DexNet().device == "cuda"
    assert tapi.DEFAULT_CONFIG == japi.DEFAULT_CONFIG
    jkey = j.add_object(sphere_obj)
    n0 = k3.launches
    key = t.add_object(sphere_obj)
    assert k3.launches == n0            # the CPU route runs K3's plain version
    assert key == jkey == "sphere" and t.list_objects() == ["sphere"]
    jsd = j.dataset.sdf(key)
    assert_sdf_equal(t.dataset.sdf(key), jsd)
    assert t.dataset.sdf(key).data.device.type == "cpu"
    tp, jp = t.dataset.stable_poses(key), j.dataset.stable_poses(key)
    assert len(tp) == len(jp) > 0
    for a, b in zip(tp, jp):
        assert a["p"] == b["p"]
        np.testing.assert_array_equal(a["r"], b["r"])
        np.testing.assert_array_equal(a["x0"], b["x0"])
    np.testing.assert_array_equal(t.dataset.mesh(key).vertices,
                                  j.dataset.mesh(key).vertices)

    # sampling and labeling on one grid: JAX's, stored into the port's
    t.dataset.store_sdf(key, tsdf.make_sdf(
        np.asarray(jsd.data), np.asarray(jsd.origin), float(jsd.resolution),
        device="cpu"), force_overwrite=True)
    rp = _Replay(monkeypatch, (js, ts), (jgen, tgen))
    want = j.sample_grasps(key, target_num_grasps=12, seed=3)
    jax_rounds = list(rp.rounds)
    want_rows, want_counts = j.compute_simulation_data(key, seed=4)

    # unreplayed: the port's own sampler inside sample_grasps, each round
    # held lane by lane against JAX's with the rounding rule of
    # test_torch_labeling_samplers: lanes that JAX's own float32 answer
    # moves under a one-ulp change of the SDF are excused. That file caps
    # them at 10% on its ellipsoid; this sphere's 128 flat facets at
    # sdf_dim 32 leave 15.2% of the 256 lanes to rounding, so the cap is 20%
    own_rounds = []

    def own_sampler(sdf, draws, **kw):
        own_rounds.append(rp.torch_sample(sdf, draws, **kw))
        assert kw == jax_rounds[len(own_rounds) - 1][1]
        return own_rounds[-1]
    monkeypatch.setattr(ts, "antipodal_sample_grasps", own_sampler)
    own = t.sample_grasps(key, target_num_grasps=12,
                          draws=LabelJaxDraws(jax.random.PRNGKey(3)))
    monkeypatch.setattr(ts, "antipodal_sample_grasps", rp.torch_fn)
    nudged = _nudged(np.asarray(jsd.data), np.asarray(jsd.origin),
                     float(jsd.resolution))
    assert len(own_rounds) == len(jax_rounds) and len(own) == 12
    for got_r, (jk, jkw, want_r) in zip(own_rounds, jax_rounds):
        _assert_sampled(got_r, want_r, _unstable(
            lambda s: rp.sample(s, jk, **jkw), nudged, want_r), 0.2)
    # A lane whose valid flag rounding flips (4 of 256 here) shifts every
    # later packed row, so the packed rows have no lane-wise tolerance
    # against JAX's. They are held instead as JAX's facade packs the port's
    # own rounds: sample_until's order, dedupe_grasps, the first 12.
    monkeypatch.setattr(js, "antipodal_sample_grasps", lambda *a, **k: (
        js.SampledGrasps(*(jnp.asarray(_n(f)) for f in own_rounds.pop(0)))))
    np.testing.assert_array_equal(own, j.sample_grasps(
        key, target_num_grasps=12, seed=3))
    assert not own_rounds
    monkeypatch.setattr(js, "antipodal_sample_grasps", rp.jax_fn)

    got = t.sample_grasps(key, target_num_grasps=12,
                          draws=LabelJaxDraws(jax.random.PRNGKey(3)))
    assert len(want) > 0
    np.testing.assert_array_equal(got, np.asarray(want))
    got_rows, got_counts = t.compute_simulation_data(
        key, draws=LabelJaxDraws(jax.random.PRNGKey(4)))
    assert not rp.rounds and len(want_rows) > 0
    n_co = _assert_rows(got_rows, want_rows, jsd)
    assert np.abs(got_counts - want_counts).sum() <= 2 * n_co
    _assert_rows(_rows(t, key), _rows(j, key), jsd)
    np.testing.assert_array_equal(_rows(t, key), got_rows)

    # export, display, close, reopen
    paths = {n: api.export_objects(str(tmp_path / f"out_{n}"))
             for n, api in (("j", j), ("t", t))}
    assert [os.path.basename(p) for p in paths["t"]] == ["sphere.obj"]
    with open(paths["t"][0], "rb") as a, open(paths["j"][0], "rb") as b:
        assert a.read() == b.read()
    t.display_object(key).savefig(str(tmp_path / "obj.png"))
    assert os.path.getsize(str(tmp_path / "obj.png")) > 1000
    assert t.display_grasps(key) is not None
    assert t.display_stable_poses(key) is not None
    for api in (j, t):
        api.close_database()
        assert api.database is None and api.dataset is None
    t2 = tapi.DexNet(device="cpu")
    t2.open_database(str(tmp_path / "t.hdf5"), create_db=False)
    t2.open_dataset("test", create_ds=False)
    np.testing.assert_array_equal(_rows(t2, key), got_rows)
    t2.close_database()


@pytest.mark.parametrize("shape", ["torus", "l_shape", "hull"])
def test_stable_poses_match_jax_where_faces_topple(shape):
    """``add_object``'s stable poses on meshes whose hull faces topple along
    long paths (a torus's hull), across edges (an L) and on a random hull:
    the port computes each face's topple target once, JAX on every visit;
    the poses are equal."""
    if shape == "torus":
        u = 2 * np.pi * np.arange(80) / 80
        w = 2 * np.pi * np.arange(30) / 30
        uu, ww = np.meshgrid(u, w, indexing="ij")
        ring = 0.05 + 0.02 * np.cos(ww)
        v = np.stack([ring * np.cos(uu), ring * np.sin(uu),
                      0.02 * np.sin(ww)], -1).reshape(-1, 3)
        i, j = np.meshgrid(np.arange(80), np.arange(30), indexing="ij")
        a, b = i * 30 + j, (i + 1) % 80 * 30 + j
        c, d = (i + 1) % 80 * 30 + (j + 1) % 30, i * 30 + (j + 1) % 30
        f = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    elif shape == "l_shape":
        v, f = _l_shape()
    else:
        from scipy.spatial import ConvexHull

        v = np.random.RandomState(2).randn(300, 3) * [0.03, 0.02, 0.05]
        f = ConvexHull(v).simplices
    f = np.asarray(f, np.int32)
    got = Mesh3D(v, f).stable_poses(min_prob=0.0)
    want = JMesh3D(v, f).stable_poses(min_prob=0.0)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g["p"] == w["p"]
        for k in ("r", "x0", "face"):
            np.testing.assert_array_equal(g[k], w[k])


def test_dexnet_stores_what_the_labeling_loop_returns(tmp_path, sphere_obj):
    """Unreplayed: the port's own sampler under injected draws. The stored
    grasps and metrics are the rows of ``label_grasps_for_object`` under the
    same draws, bit for bit; ``sample_grasps`` packs ``sample_until``'s
    valid rows, deduped."""
    t = tapi.DexNet({**CONFIG, "cache_dir": str(tmp_path / "c")},
                    device="cpu")
    t.open_database(str(tmp_path / "t.hdf5"))
    t.open_dataset("d")
    key = t.add_object(sphere_obj)
    rows, counts = t.compute_simulation_data(
        key, draws=LabelJaxDraws(jax.random.PRNGKey(1)))
    sdf = t.dataset.sdf(key)
    com = t.dataset.mesh(key).center_of_mass()
    again = tgen.label_grasps_for_object(
        sdf, com, Gripper(), LabelJaxDraws(jax.random.PRNGKey(1)),
        grasps_per_class=CONFIG["grasps_per_class"])
    assert len(rows) > 0 and rows.dtype == np.float32
    np.testing.assert_array_equal(rows, again.rows)
    np.testing.assert_array_equal(counts, again.counts)
    configs, metrics = t.get_grasps(key)
    np.testing.assert_array_equal(configs, rows[:, :10])
    np.testing.assert_array_equal(metrics["friction"], rows[:, 10])
    np.testing.assert_array_equal(metrics["robust_ferrari_canny"],
                                  rows[:, 11])
    # default draws: Draws(seed) on the facade's device
    a = t.sample_grasps(key, target_num_grasps=5, seed=2)
    b = t.sample_grasps(key, target_num_grasps=5, seed=2)
    assert 0 < len(a) <= 5 and a.shape[1] == 10
    np.testing.assert_array_equal(a, b)
    t.compute_simulation_data(key, seed=0, store=False)
    np.testing.assert_array_equal(t.get_grasps(key)[0], configs)
    t.delete_object(key)
    assert t.list_objects() == []
    t.close_database()


def test_dexnet_errors_match_jax(tmp_path):
    for mod in (japi, tapi):
        api = mod.DexNet()
        with pytest.raises(RuntimeError):
            api.open_dataset("x")
        with pytest.raises(RuntimeError):
            api.list_objects()
        with pytest.raises(ValueError):
            api.open_database(str(tmp_path / "bad.txt"))
        with pytest.raises(ValueError):
            api.open_database(str(tmp_path / "none.hdf5"), create_db=False)


# ---------------------------------------------------------------------------
# The interactive CLI
# ---------------------------------------------------------------------------

def test_scripted_cli_session_matches_jax(tmp_path, sphere_obj, monkeypatch,
                                          capsys, jax_canny64):
    """tests/test_api.py's session on both packages. The port's session
    reads the SDF that JAX's wrote into the shared mesh cache (its
    ``MeshProcessor`` reads a cached .sdf newer than the mesh), so both
    label one grid; the port gets JAX's draws and replayed rounds."""
    cache = str(tmp_path / "cache")
    rp = _Replay(monkeypatch, (jgen, tgen))
    out = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        cli = mod.DexNetCli() if name == "jax" else mod.DexNetCli("cpu")
        cli.api.config.update({"sdf_dim": 32, "sdf_padding": 3,
                               "grasps_per_class": 1, "cache_dir": cache})
        if name == "port":
            orig = cli.api.compute_simulation_data
            cli.api.compute_simulation_data = lambda key, seed=0, **kw: orig(
                key, draws=LabelJaxDraws(jax.random.PRNGKey(seed)), **kw)
        d = tmp_path / name
        d.mkdir()
        capsys.readouterr()
        run = lambda: cli.run(script=[
            f"open_database {d}/cli.hdf5",
            "open_dataset main",
            f"add_object {sphere_obj}",
            "list_objects",
            "compute_grasps sphere",
            "show_grasps sphere",
            f"display_object sphere {d}/sphere.png",
            f"export_objects {d}/export",
            "unknown_command",     # must not crash
            "quit",
        ])
        run()
        out[name] = capsys.readouterr().out.replace(str(d), "<dir>")
        assert os.path.exists(d / "sphere.png")
        assert os.path.exists(d / "export" / "sphere.obj")
    assert not rp.rounds
    dbs = {}
    for name, mod in (("jax", japi), ("port", tapi)):
        api = mod.DexNet() if name == "jax" else mod.DexNet(device="cpu")
        api.open_database(str(tmp_path / name / "cli.hdf5"), create_db=False)
        api.open_dataset("main", create_ds=False)
        dbs[name] = (_rows(api, "sphere"), api.dataset.sdf("sphere"))
        api.close_database()
    jsd = dbs["jax"][1]
    n_co = _assert_rows(dbs["port"][0], dbs["jax"][0], jsd)
    # the printed lines are the same, but where a grasp whose two contacts
    # coincide (JAX's own close_fingers, as ``_assert_rows`` finds them)
    # took a class's place in either session: its friction label is
    # rounding (ROADMAP Queue C item 7), so another grasp may fill the class
    co = {name: np.linalg.norm(np.diff(np.asarray(jg.close_fingers(
        jsd, jnp.asarray(rows[:, :10]), check_approach=False).points),
        axis=1)[:, 0], axis=1) < 1e-4 for name, (rows, _) in dbs.items()}
    got, want = out["port"].splitlines(), out["jax"].splitlines()
    assert len(got) == len(want)
    differ = [(a, b) for a, b in zip(got, want) if a != b]
    assert len(differ) <= n_co
    for a, b in differ:
        k = int(a.split("]")[0].strip(" ["))
        assert b.startswith(f"  [{k}] center=") and (co["port"][k]
                                                     or co["jax"][k]), (a, b)
    assert "stored" in out["port"] and "unknown command" in out["port"]


def test_cli_main_takes_a_device(monkeypatch):
    seen = []
    monkeypatch.setattr(tcli.DexNetCli, "run", lambda self: seen.append(
        self.api.device))
    assert tcli.main(["--device", "cpu"]) == 0
    assert tcli.main([]) == 0
    assert seen == ["cpu", "cuda"]
    assert [c[:2] for c in tcli.DexNetCli("cpu").commands] == [
        c[:2] for c in jcli.DexNetCli().commands]


# ---------------------------------------------------------------------------
# URDF writer, image converter, plots
# ---------------------------------------------------------------------------

def _l_shape():
    a, b = box([0, 0, 0], [2, 1, 1]), box([0, 0, 1], [1, 1, 2])
    m = JMesh3D(*a).merge(JMesh3D(*b))
    return m.vertices, m.triangles


def test_urdf_writer_matches_jax(tmp_path):
    v, f = _l_shape()
    want = jurdf.UrdfWriter(str(tmp_path / "j")).write(JMesh3D(v, f),
                                                        name="l")
    got = turdf.UrdfWriter(str(tmp_path / "t"), device="cpu").write(
        Mesh3D(v, f), name="l")
    assert os.path.basename(got) == os.path.basename(want) == "l.urdf"
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert "l_piece_1.obj" in names
    for n in names:
        assert ((tmp_path / "t" / n).read_bytes()
                == (tmp_path / "j" / n).read_bytes()), n
    # given pieces: no decomposition, no voxelizer
    n0 = k3.launches
    turdf.UrdfWriter(str(tmp_path / "p"), device="cpu").write(
        Mesh3D(v, f), name="p", pieces=[Mesh3D(v, f).convex_hull()])
    assert k3.launches == n0
    assert sorted(os.listdir(tmp_path / "p")) == ["p.urdf", "p_piece_0.obj"]


def test_urdf_writer_lets_a_voxelizer_error_propagate(tmp_path, monkeypatch):
    """The JAX package turns any exception of the decomposition into the
    convex hull (``geometry/urdf_writer.py:29-32``); the port lets an
    error of the voxelizer (a K3 build or launch failure) propagate and
    falls back only where qhull fails on a cluster."""
    v, f = _l_shape()

    def broken(*a, **k):
        raise RuntimeError("point_triangle_launch failed")

    jm = importlib.import_module("pointnetgpd_tpu.ops.mesh_to_sdf")
    tm = importlib.import_module("pointnetgpd_tpu_torch.ops.mesh_to_sdf")
    monkeypatch.setattr(jm, "mesh_to_sdf", broken)
    monkeypatch.setattr(tm, "mesh_to_sdf", broken)
    jpath = jurdf.UrdfWriter(str(tmp_path / "j")).write(JMesh3D(v, f),
                                                         name="l")
    assert "l_piece_1.obj" not in open(jpath).read()   # JAX: one hull
    with pytest.raises(RuntimeError, match="point_triangle_launch"):
        turdf.UrdfWriter(str(tmp_path / "t"), device="cpu").write(
            Mesh3D(v, f), name="l")
    assert not os.path.exists(tmp_path / "t" / "l.urdf")
    monkeypatch.setattr(tm, "mesh_to_sdf", lambda *a, **k: (_ for _ in ()
                                                            ).throw(
        ValueError("K3: points must be float32")))
    with pytest.raises(ValueError):
        turdf.convex_decomposition(Mesh3D(v, f), device="cpu", dim=16)
    monkeypatch.undo()

    from scipy.spatial import QhullError

    from pointnetgpd_tpu_torch.geometry import decomposition as tdec

    def no_hull(points):
        raise QhullError("QH6154 initial simplex is flat")

    monkeypatch.setattr(tdec, "_hull_mesh", no_hull)
    pieces = turdf.convex_decomposition(Mesh3D(v, f), device="cpu", dim=16)
    assert len(pieces) == 1
    np.testing.assert_array_equal(pieces[0].vertices,
                                  Mesh3D(v, f).convex_hull().vertices)


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_binary_image_to_mesh_matches_jax(seed):
    if seed is None:                     # tests/test_extras.py's image
        im = np.zeros((16, 16), np.uint8)
        im[4:12, 5:11] = 1
    else:
        im = (np.random.RandomState(seed).rand(12, 14) > 0.5).astype(np.uint8)
    got = timc.binary_image_to_mesh(im, extrusion=4.0, scale_factor=0.01)
    want = jimc.binary_image_to_mesh(im, extrusion=4.0, scale_factor=0.01)
    assert got.vertices.dtype == want.vertices.dtype
    assert got.triangles.dtype == want.triangles.dtype
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    if seed is None:
        assert got.is_watertight()
        np.testing.assert_allclose(got.volume(), 8 * 6 * 4 * 1e-6, rtol=1e-6)
    for mod in (timc, jimc):
        with pytest.raises(ValueError):
            mod.binary_image_to_mesh(np.zeros((8, 8)))


def _lines(fig):
    return [np.asarray(ln.get_data_3d()) for ax in fig.axes
            for ln in ax.lines]


def test_plots_match_jax():
    v, f = box([-0.03, -0.02, -0.04], [0.03, 0.02, 0.04])
    rs = np.random.RandomState(3)
    cfg = np.zeros((30, 10), np.float32)
    cfg[:, :3] = rs.randn(30, 3) * 0.01
    ax = rs.randn(30, 3)
    cfg[:, 3:6] = ax / np.linalg.norm(ax, axis=1, keepdims=True)
    cfg[:, 6] = 0.085
    scores = rs.rand(30).astype(np.float32)
    got = tplots.plot_grasps_3d(Mesh3D(v, f), cfg, scores=scores)
    want = jplots.plot_grasps_3d(JMesh3D(v, f), cfg, scores=scores)
    lg, lw = _lines(got), _lines(want)
    assert len(lg) == len(lw) == 25           # max_plot
    for a, b in zip(lg, lw):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.axes[0].lines, want.axes[0].lines):
        assert a.get_color() == b.get_color()
    bc, ap, bn, mn = np.zeros(3), [1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]
    for a, b in zip(_lines(tplots.plot_gripper_3d(bc, ap, bn, mn)),
                    _lines(jplots.plot_gripper_3d(bc, ap, bn, mn))):
        np.testing.assert_array_equal(a, b)
    poses = Mesh3D(v, f).stable_poses()
    assert len(tplots.plot_stable_poses(Mesh3D(v, f), poses).axes) == len(
        poses)
    import pointnetgpd_tpu.visualization as jvis
    import pointnetgpd_tpu_torch.visualization as tvis

    assert tvis.__all__ == jvis.__all__
    import matplotlib.pyplot as plt

    plt.close("all")


# ---------------------------------------------------------------------------
# Diagnostic tools
# ---------------------------------------------------------------------------

def test_compare_normals_matches_jax(tmp_path, monkeypatch, capsys):
    """The same ``RandomState`` subset of surface cells and its world
    points; the SDF plane-fit normals within 1e-4, the tolerance of
    ``test_torch_labeling.py::test_surface_normal_matches_jax``, on the
    points the fit calls valid (the same set on both sides); the KNN
    normals within 1e-4, the tolerance of
    ``test_torch_cloud_sampler.py::test_estimate_normals_knn``. The
    printed agreement line is the same."""
    data, origin, res = ellipsoid_data()
    path = str(tmp_path / "e.sdf")
    jwrite_sdf(path, jsdf.make_sdf(data, origin, res))
    seen = {}

    def spy(mod, name):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            seen[name] = orig(*a, **k)
            return seen[name]
        monkeypatch.setattr(mod, name, wrapped)

    spy(jsdf, "grid_to_world")
    spy(jsdf, "surface_normal")
    spy(jcloud, "estimate_normals_knn")
    jtools.compare_normals(path, str(tmp_path / "j.png"), n_points=300)
    want_line = capsys.readouterr().out
    idx, pts, n_sdf, valid, n_knn = ttools.sdf_and_knn_normals(
        path, n_points=300, seed=0, device="cpu")
    ttools.compare_normals(path, str(tmp_path / "t.png"), n_points=300,
                           device="cpu")
    assert capsys.readouterr().out == want_line
    assert os.path.getsize(tmp_path / "t.png") > 1000
    np.testing.assert_array_equal(
        idx, np.random.RandomState(0).choice(len(
            jsdf.make_sdf(data, origin, res).surface_points), 300,
            replace=False))
    np.testing.assert_array_equal(pts, np.asarray(seen["grid_to_world"]))
    jn, jv = (np.asarray(a) for a in seen["surface_normal"])
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 250
    np.testing.assert_allclose(n_sdf[valid], jn[valid], atol=1e-4)
    np.testing.assert_allclose(n_knn, np.asarray(
        seen["estimate_normals_knn"]), atol=1e-4)


def test_show_tools_write_their_pngs(tmp_path, capsys):
    """``show_grasp_file``, ``show_clouds`` and ``visualize_gqcnn_dataset``
    each write a PNG, and print what JAX's print."""
    v, f = box([-0.03, -0.02, 0.0], [0.03, 0.02, 0.09])
    obj = str(tmp_path / "box.obj")
    jwrite_obj(obj, v, f)
    rs = np.random.RandomState(0)
    rows = np.zeros((6, 12), np.float32)
    rows[:, :3] = rs.randn(6, 3) * 0.01
    rows[:, 3:6] = [1.0, 0, 0]
    rows[:, 6] = 0.085
    rows[:, 10] = [0.4, 0.4, 0.8, 0.8, 1.2, 1.2]
    rows[:, 11] = rs.rand(6)
    np.save(tmp_path / "g.npy", rows)
    clouds = tmp_path / "clouds"
    clouds.mkdir()
    for i in range(3):
        np.save(clouds / f"pc_{i}.npy", rs.rand(500, 3).astype(np.float32))
    from pointnetgpd_tpu_torch.learning.tensor_dataset import TensorDataset

    ds = TensorDataset(str(tmp_path / "gq"), {
        "depth_ims_tf_table": {"shape": [8, 8, 1], "dtype": "float32"},
        "metrics": {"shape": [], "dtype": "float32"}}, 4)
    for i in range(6):
        dp = ds.datapoint_template()
        dp["depth_ims_tf_table"] = rs.rand(8, 8, 1).astype(np.float32)
        dp["metrics"] = np.float32(i / 6)
        ds.add(dp)
    ds.flush()
    for name, mod in (("jx", jtools), ("pt", ttools)):
        mod.show_grasp_file(str(tmp_path / "g.npy"), obj,
                            str(tmp_path / f"{name}-g.png"))
        mod.show_clouds(str(clouds / "*.npy"), str(tmp_path / f"{name}-c.png"),
                        obj_path=obj)
        mod.visualize_gqcnn_dataset(str(tmp_path / "gq"),
                                    str(tmp_path / f"{name}-q.png"),
                                    num_samples=4)
        out = capsys.readouterr().out.replace(f"{name}-", "<p>-")
        if name == "jx":
            want = out
    assert out == want and "4 samples from 6" in out
    for kind in "gcq":
        assert os.path.getsize(tmp_path / f"pt-{kind}.png") > 1000
    with pytest.raises(FileNotFoundError):
        ttools.show_clouds(str(tmp_path / "none" / "*.npy"),
                           str(tmp_path / "x.png"))
    ttools.main(["--device", "cpu", "show-grasps", str(tmp_path / "g.npy"),
                 obj, str(tmp_path / "m.png")])
    assert os.path.exists(tmp_path / "m.png")
    import matplotlib.pyplot as plt

    plt.close("all")
