"""The port's HDF5 object/grasp database, its chunked tensor dataset and the
G-Q-CNN dataset renderer against the JAX package.

- A database filled by one package from the same seeded inputs (a mesh, an
  SDF, stable poses, grasps with two metrics, convex pieces, rendered
  images, a metric config with a nested dict, metadata) reads back equal in
  the other, and the two packages' files hold the same h5py tree: names,
  dtypes, shapes, values and attributes, apart from the creation time and
  the grasps' timestamp. Everything here is host storage, so equal means
  equal, with no tolerance.
- JAX's own checks of the database (an illegal create, overwrite
  protection, ``delete_*``) hold for both packages.
- ``TensorDataset`` files written by either package open in the other.
- ``generate_gqcnn_dataset`` on a database written by JAX writes the same
  files as JAX's: both render with the repository's native rasterizer and
  crop in numpy.
"""

import os

import numpy as np
import pytest
import torch

from pointnetgpd_tpu.database import hdf5 as jdb
from pointnetgpd_tpu.geometry import sdf as jsdf
from pointnetgpd_tpu.geometry.mesh import Mesh3D as JMesh3D
from pointnetgpd_tpu.learning import tensor_dataset as jtd
from pointnetgpd_tpu.pipelines import gqcnn_dataset as jgq
from pointnetgpd_tpu_torch import constants as tconst
from pointnetgpd_tpu_torch.database import hdf5 as tdb
from pointnetgpd_tpu_torch.database import keys as tkeys
from pointnetgpd_tpu_torch.geometry import sdf as tsdf
from pointnetgpd_tpu_torch.geometry.mesh import Mesh3D
from pointnetgpd_tpu_torch.learning import tensor_dataset as ttd
from pointnetgpd_tpu_torch.pipelines import gqcnn_dataset as tgq
from test_mesh import unit_cube

PKGS = {"jax": (jdb, JMesh3D, jsdf.make_sdf),
        "port": (tdb, Mesh3D,
                 lambda d, o, r: tsdf.make_sdf(d, o, r, device="cpu"))}
SKIP_ATTRS = ("time_created", "timestamp")


def _open(pkg, path, access):
    db, _, _ = PKGS[pkg]
    if pkg == "port":
        return db.Hdf5Database(path, access, device="cpu")
    return db.Hdf5Database(path, access)


def _inputs(seed=0):
    """Everything the schema holds, made from a seed."""
    rs = np.random.RandomState(seed)
    cube = unit_cube()
    v = (cube.vertices - 0.5) * 0.08 + rs.randn(8, 3) * 1e-3
    dim, res = 12, 0.01
    data = (rs.rand(dim, dim, dim) - 0.4).astype(np.float32) * 0.05
    configs = np.zeros((7, 10), np.float32)
    configs[:, :3] = rs.randn(7, 3) * 0.01
    ax = rs.randn(7, 3)
    configs[:, 3:6] = ax / np.linalg.norm(ax, axis=1, keepdims=True)
    configs[:, 6] = 0.085
    return dict(
        v=v, f=cube.triangles, data=data,
        origin=np.array([-0.055, -0.05, -0.06]), res=res,
        configs=configs,
        metrics={"friction": rs.rand(7).astype(np.float32),
                 "robust_ferrari_canny": rs.rand(7).astype(np.float32)},
        images=[rs.rand(16, 20).astype(np.float32) for _ in range(3)],
        metric_cfg={"quality_method": "ferrari_canny_L1",
                    "num_cone_faces": 8, "friction_coef": 0.5,
                    "grasp_uncertainty": {"sigma_grasp_trans_x": 0.005,
                                          "num_samples": 10}})


def _fill(pkg, path, inp):
    """Write ``inp`` into a new database at ``path`` with one package."""
    db_mod, mesh_cls, make_sdf = PKGS[pkg]
    mesh = mesh_cls(inp["v"], inp["f"])
    db = _open(pkg, path, db_mod.READ_WRITE_ACCESS)
    ds = db.create_dataset("ycb")
    ds.create_graspable("cube", mesh=mesh,
                        sdf=make_sdf(inp["data"], inp["origin"], inp["res"]),
                        stable_poses=mesh.stable_poses(), mass=0.25,
                        category="box")
    ds.store_grasps("cube", inp["configs"], gripper="robotiq_85",
                    metrics=inp["metrics"])
    ds.store_convex_pieces("cube", [mesh, mesh.rescale(0.5)])
    ds.store_rendered_images("cube", inp["images"], stable_pose_id="pose_0")
    ds.create_metric("robust_ferrari_canny", inp["metric_cfg"])
    ds.create_metadata("scale", {"type": "float", "description": "scale"})
    ds.set_object_metadata("cube", "scale", 1.5)
    ds.create_graspable("empty")
    db.flush()
    db.close()


def _read(pkg, path):
    """Everything readable through one package's accessors, as host data."""
    db = _open(pkg, path, PKGS[pkg][0].READ_ONLY_ACCESS)
    ds = db.dataset("ycb")
    sdf = ds.sdf("cube")
    mesh = ds.mesh("cube")
    out = {
        "datasets": db.dataset_names, "keys": ds.object_keys,
        "num_objects": ds.num_objects,
        "vertices": mesh.vertices, "triangles": mesh.triangles,
        "density": mesh.density,
        "sdf": [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                for a in sdf],
        "mass": ds.mass("cube"), "category": ds.category("cube"),
        "poses": ds.stable_poses("cube"),
        "grasps": ds.grasps("cube", "robotiq_85"),
        "metrics": ds.grasp_metrics("cube", "robotiq_85"),
        "has_grasps": (ds.has_grasps("cube", "robotiq_85"),
                       ds.has_grasps("empty", "robotiq_85")),
        "pieces": [(p.vertices, p.triangles)
                   for p in ds.convex_pieces("cube")],
        "images": ds.rendered_images("cube", "pose_0"),
        "metric_names": ds.metric_names,
        "metric": ds.metric("robust_ferrari_canny"),
        "has_metric": ds.has_metric("robust_ferrari_canny"),
        "metadata_names": ds.metadata_names,
        "object_metadata": ds.object_metadata("cube"),
        "contains": ("cube" in ds, "nothing" in ds),
        "iter": list(ds),
    }
    db.close()
    return out, sdf


def _assert_same(a, b, path="."):
    """Equal values of equal types, recursively; arrays of equal dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                            b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def h5_tree(path):
    """{name: (kind, dtype, shape, value, attrs)} of every group and dataset
    of an HDF5 file, the root included; timestamps left out."""
    import h5py

    out = {}

    def visit(name, obj):
        attrs = {k: v for k, v in obj.attrs.items() if k not in SKIP_ATTRS}
        if isinstance(obj, h5py.Dataset):
            out[name] = ("dataset", obj.dtype.str, obj.shape, obj[()], attrs)
        else:
            out[name] = ("group", None, None, None, attrs)

    with h5py.File(path, "r") as f:
        visit("/", f)
        f.visititems(visit)
    return out


def _assert_same_tree(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        assert g[:3] == w[:3], (name, g[:3], w[:3])
        if w[0] == "dataset":
            np.testing.assert_array_equal(g[3], w[3], err_msg=name)
        assert sorted(g[4]) == sorted(w[4]), name
        for k in w[4]:
            ga, wa = np.asarray(g[4][k]), np.asarray(w[4][k])
            assert ga.dtype == wa.dtype, (name, k, ga.dtype, wa.dtype)
            np.testing.assert_array_equal(ga, wa, err_msg=f"{name}@{k}")


# ---------------------------------------------------------------------------
# Schema and constants
# ---------------------------------------------------------------------------

def test_keys_and_access_levels_match_jax():
    from pointnetgpd_tpu import constants as jconst
    from pointnetgpd_tpu.database import keys as jkeys

    names = [n for n in dir(jkeys) if n.endswith("_KEY")]
    assert names and names == [n for n in dir(tkeys) if n.endswith("_KEY")]
    for n in names:
        assert getattr(tkeys, n) == getattr(jkeys, n)
    assert tconst.READ_ONLY_ACCESS == jconst.READ_ONLY_ACCESS
    assert tconst.READ_WRITE_ACCESS == jconst.READ_WRITE_ACCESS
    assert tdb.READ_ONLY_ACCESS is tconst.READ_ONLY_ACCESS
    import pointnetgpd_tpu.database as jpkg
    import pointnetgpd_tpu_torch.database as tpkg

    assert tpkg.__all__ == jpkg.__all__
    assert all(hasattr(tpkg, n) for n in tpkg.__all__)


# ---------------------------------------------------------------------------
# HDF5 interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_database_reads_equal_in_the_other_package(tmp_path, writer, reader):
    """A file written by ``writer`` reads in ``reader`` as in ``writer``
    itself: the same objects, arrays (in the same dtypes) and attributes.
    The SDF read by the port is an ``SdfGrid`` on the database's device,
    built by ``make_sdf`` from the stored grid."""
    inp = _inputs()
    path = str(tmp_path / "db.hdf5")
    _fill(writer, path, inp)
    got, got_sdf = _read(reader, path)
    want, want_sdf = _read(writer, path)
    _assert_same(got, want)
    assert got["keys"] == ["cube", "empty"]
    assert got["grasps"].dtype == np.float32 and got["grasps"].shape == (7, 10)
    assert got["metric"]["grasp_uncertainty"]["num_samples"] == 10
    port_sdf = got_sdf if reader == "port" else want_sdf
    assert port_sdf.data.device.type == "cpu"
    assert port_sdf.origin.dtype == torch.float32
    np.testing.assert_array_equal(port_sdf.data.numpy(), inp["data"])


def test_both_packages_write_the_same_h5py_tree(tmp_path):
    """The same inputs through each package's store methods give the same
    file: every name, dtype, shape, value and attribute (timestamps
    aside)."""
    inp = _inputs(1)
    paths = {pkg: str(tmp_path / f"{pkg}.hdf5") for pkg in PKGS}
    for pkg, path in paths.items():
        _fill(pkg, path, inp)
    want, got = h5_tree(paths["jax"]), h5_tree(paths["port"])
    _assert_same_tree(got, want)
    # the dtypes the JAX package writes (x64 on or off alike)
    assert want["datasets/ycb/objects/cube/sdf/origin"][1] == "<f4"
    assert want["datasets/ycb/objects/cube/sdf/data"][1] == "<f4"
    assert want["datasets/ycb/objects/cube/mesh/triangles"][1] == "<i4"
    assert want["datasets/ycb/objects/cube/grasps/robotiq_85/configuration"][
        1:3] == ("<f4", (7, 10))


def test_store_accepts_tensors_on_any_device(tmp_path):
    """The port's store methods take tensors as well as arrays, and write
    them in their own dtype."""
    inp = _inputs(2)
    paths = {}
    for kind in ("numpy", "tensor"):
        paths[kind] = str(tmp_path / f"{kind}.hdf5")
        db = tdb.Hdf5Database(paths[kind], tdb.READ_WRITE_ACCESS,
                              device="cpu")
        ds = db.create_dataset("d")
        ds.create_graspable("o")
        wrap = torch.from_numpy if kind == "tensor" else np.asarray
        ds.store_grasps("o", wrap(inp["configs"]), gripper="g",
                        metrics={k: wrap(v) for k, v in inp["metrics"].items()})
        ds.store_rendered_images("o", [wrap(im) for im in inp["images"]])
        db.close()
    _assert_same_tree(h5_tree(paths["tensor"]), h5_tree(paths["numpy"]))


# ---------------------------------------------------------------------------
# JAX's own checks (tests/test_database.py), on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", list(PKGS))
def test_illegal_create_fails(tmp_path, pkg):
    db_mod = PKGS[pkg][0]
    with pytest.raises(ValueError):
        _open(pkg, str(tmp_path / "db.h5"), db_mod.READ_WRITE_ACCESS)
    with pytest.raises(ValueError):
        _open(pkg, str(tmp_path / "missing.hdf5"), db_mod.READ_ONLY_ACCESS)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_overwrite_protection_and_deletes(tmp_path, pkg):
    db_mod, mesh_cls, make_sdf = PKGS[pkg]
    inp = _inputs(3)
    mesh = mesh_cls(inp["v"], inp["f"])
    sdf = make_sdf(inp["data"], inp["origin"], inp["res"])
    db = _open(pkg, str(tmp_path / "t.hdf5"), db_mod.READ_WRITE_ACCESS)
    ds = db.create_dataset("d")
    ds.create_graspable("o", mesh=mesh, sdf=sdf,
                        stable_poses=mesh.stable_poses())
    ds.store_grasps("o", np.zeros((2, 10)))
    ds.store_convex_pieces("o", [mesh])
    ds.store_rendered_images("o", inp["images"])
    for store, arg in ((ds.store_grasps, np.zeros((2, 10))),
                       (ds.store_mesh, mesh), (ds.store_sdf, sdf),
                       (ds.store_stable_poses, mesh.stable_poses()),
                       (ds.store_convex_pieces, [mesh]),
                       (ds.store_rendered_images, inp["images"])):
        with pytest.raises(ValueError):
            store("o", arg)
        store("o", arg, force_overwrite=True)
    ds.store_grasps("o", np.ones((3, 10)), force_overwrite=True)
    assert len(ds.grasps("o")) == 3
    ds.delete_grasps("o")
    assert not ds.has_grasps("o")
    ds.create_metric("m", {"a": 1})
    assert ds.has_metric("m")
    ds.delete_metric("m")
    assert not ds.has_metric("m") and ds.metric_names == []
    ds.delete_graspable("o")
    assert ds.num_objects == 0 and "o" not in ds
    db.create_dataset("e")
    db.delete_dataset("d")
    assert db.dataset_names == ["e"]
    with pytest.raises(KeyError):
        db.dataset("d")
    assert db["e"].name == "e"
    db.close()


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_obj_mesh_filename_matches_jax(tmp_path, scale):
    inp = _inputs(4)
    paths = {}
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg}.hdf5")
        _fill(pkg, path, inp)
        db = _open(pkg, path, PKGS[pkg][0].READ_ONLY_ACCESS)
        out = tmp_path / pkg
        out.mkdir()
        paths[pkg] = db.dataset("ycb").obj_mesh_filename(
            "cube", scale=scale, output_dir=str(out))
        db.close()
    assert os.path.basename(paths["port"]) == "cube.obj"
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# TensorDataset
# ---------------------------------------------------------------------------

CONFIG = {"depth_ims_tf_table": {"shape": [4, 4, 1], "dtype": "float32"},
          "hand_poses": {"shape": [4], "dtype": "float32"},
          "metrics": {"shape": [], "dtype": "float32"},
          "obj_ids": {"shape": [], "dtype": "int64"}}


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            rel = os.path.relpath(p, root)
            if n.endswith(".npz"):
                with np.load(p) as z:
                    out[rel] = {k: z[k] for k in z.files}
            else:
                with open(p) as fh:
                    out[rel] = fh.read()
    return out


def _assert_same_files(got_dir, want_dir):
    got, want = _files(got_dir), _files(want_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        if isinstance(want[name], dict):
            for k in want[name]:
                assert got[name][k].dtype == want[name][k].dtype
                np.testing.assert_array_equal(got[name][k], want[name][k],
                                              err_msg=name)
        else:
            assert got[name] == want[name], name


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_tensor_dataset_opens_in_the_other_package(tmp_path, writer, reader):
    mods = {"jax": jtd, "port": ttd}
    rs = np.random.RandomState(5)
    written = {}
    for pkg in (writer, reader):
        d = str(tmp_path / pkg)
        ds = mods[pkg].TensorDataset(d, CONFIG, datapoints_per_file=4)
        for i in range(10):
            dp = ds.datapoint_template()
            dp["depth_ims_tf_table"] = rs.rand(4, 4, 1).astype(np.float32)
            dp["hand_poses"] = rs.rand(4).astype(np.float32)
            dp["metrics"] = np.float32(i / 10)
            dp["obj_ids"] = np.int64(i % 3)
            ds.add(dp)
        ds.flush()
        written[pkg] = d
        rs = np.random.RandomState(5)
    _assert_same_files(written[reader], written[writer])
    got = mods[reader].TensorDataset.open(written[writer])
    want = mods[writer].TensorDataset.open(written[writer])
    assert len(got) == len(want) == 10
    for i in range(10):
        a, b = got.datapoint(i), want.datapoint(i)
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(IndexError):
        got.datapoint(10)


# ---------------------------------------------------------------------------
# G-Q-CNN dataset
# ---------------------------------------------------------------------------

def _grasp_db(path):
    """A JAX-written database: the cube at 8 cm with stored grasps."""
    db = jdb.Hdf5Database(path, jdb.READ_WRITE_ACCESS)
    ds = db.create_dataset("d")
    mesh = JMesh3D((unit_cube().vertices - 0.5) * 0.08, unit_cube().triangles)
    ds.create_graspable("cube", mesh=mesh, stable_poses=mesh.stable_poses())
    ds.create_graspable("bare", mesh=mesh)          # no grasps: skipped
    rs = np.random.RandomState(0)
    configs = np.zeros((6, 10))
    configs[:, 0:3] = rs.randn(6, 3) * 0.01
    axes = rs.randn(6, 3)
    configs[:, 3:6] = axes / np.linalg.norm(axes, axis=1, keepdims=True)
    configs[:, 6] = 0.08
    ds.store_grasps("cube", configs, gripper="robotiq_85",
                    metrics={"robust_ferrari_canny": rs.rand(6)})
    db.close()


def test_gqcnn_dataset_matches_jax(tmp_path):
    path = str(tmp_path / "g.hdf5")
    _grasp_db(path)
    kw = dict(num_elev=1, num_az=2, im_size=16, crop_size=48,
              datapoints_per_file=8)
    outs = {}
    for pkg, db_mod, gq in (("jax", jdb, jgq), ("port", tdb, tgq)):
        db = (db_mod.Hdf5Database(path, device="cpu") if pkg == "port"
              else db_mod.Hdf5Database(path))
        outs[pkg] = gq.generate_gqcnn_dataset(db.dataset("d"),
                                              str(tmp_path / pkg), **kw)
        db.close()
    assert len(outs["port"]) == len(outs["jax"]) > 8     # two chunks
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    dp = ttd.TensorDataset.open(str(tmp_path / "jax")).datapoint(0)
    assert dp["depth_ims_tf_table"].shape == (16, 16, 1)
    assert np.isfinite(dp["depth_ims_tf_table"]).all()
    # the projection and the crop are the JAX package's numpy
    rs = np.random.RandomState(1)
    im = rs.rand(40, 50).astype(np.float32)
    np.testing.assert_array_equal(
        tgq.extract_aligned_crop(im, 20.3, 17.9, 0.7, 24, 12),
        jgq.extract_aligned_crop(im, 20.3, 17.9, 0.7, 24, 12))


def test_gqcnn_main_and_missing_metric(tmp_path, capsys):
    path = str(tmp_path / "g.hdf5")
    _grasp_db(path)
    tgq.main([path, "d", str(tmp_path / "port"), "--im-size", "8"])
    jgq.main([path, "d", str(tmp_path / "jax"), "--im-size", "8"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace("port", "jax") == lines[1]
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    db = tdb.Hdf5Database(path, device="cpu")
    with pytest.raises(KeyError, match="no grasp metric 'typo'"):
        tgq.generate_gqcnn_dataset(db.dataset("d"), str(tmp_path / "x"),
                                   metric_name="typo")
    db.close()
