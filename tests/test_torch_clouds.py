"""The port's RGB-D -> cloud path against the JAX package: the three
per-pixel functions of ``pipelines/ycb_clouds.py`` (jitted JAX, x64 off as
in the JAX package's own runtime), the writers, ``generate_frame`` end to
end, the rasterizer binding, the cameras and ``render_object_clouds``.

``register_depth_map`` picks pixels by ``floor`` of float32 values, so it
is compared on every pixel, on frames whose projections sit on the .5
boundaries where the rounding decides; the cloud to 1e-6 x (1 + |ref|);
files byte for byte. The cases marked ``cuda`` hold the card route to the
CPU route and skip without a GPU.
"""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointnetgpd_tpu.geometry.mesh import Mesh3D as JMesh3D
from pointnetgpd_tpu.pipelines import render_clouds as jrender
from pointnetgpd_tpu.pipelines import ycb_clouds as jycb
from pointnetgpd_tpu.render import camera as jcamera
from pointnetgpd_tpu.render import native as jnative
from pointnetgpd_tpu.render import random_variables as jrv
from pointnetgpd_tpu_torch.geometry.mesh import Mesh3D
from pointnetgpd_tpu_torch.pipelines import render_clouds as trender
from pointnetgpd_tpu_torch.pipelines import ycb_clouds as tycb
from pointnetgpd_tpu_torch.render import camera as tcamera
from pointnetgpd_tpu_torch.render import native as tnative
from pointnetgpd_tpu_torch.render import random_variables as trv
from test_mesh import unit_cube
from test_render_clouds import _sphere_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: compares the card route with the CPU")
    return torch.device("cuda")


def _t(a, dev="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _rotation(rs, scale=0.08):
    a = rs.randn(3) * scale
    c, s = np.cos(a), np.sin(a)
    return (np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
            @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
            @ np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]]))


def _jit_register(depth, dk, rk, h, out_hw):
    with jax.enable_x64(False):
        return np.asarray(jycb.register_depth_map(
            jnp.asarray(depth), jnp.asarray(dk), jnp.asarray(rk),
            jnp.asarray(h), out_height=out_hw[0], out_width=out_hw[1]))


def _register(depth, dk, rk, h, out_hw, dev="cpu"):
    return tycb.register_depth_map(
        _t(depth, dev), _t(dk, dev), _t(rk, dev), _t(h, dev),
        out_height=out_hw[0], out_width=out_hw[1]).cpu().numpy()


def boundary_frame(seed, h=48, w=64):
    """A depth frame whose every pixel projects onto a .5 boundary of the
    RGB image's u axis (in float64, before the float32 rounding decides),
    through a general rotation and translation. Returns (depth, depth_k,
    rgb_k, h_rgb_from_depth)."""
    rs = np.random.RandomState(seed)
    dk = np.array([[52.25, 0, 31.5], [0, 51.75, 23.5], [0, 0, 1]])
    rk = np.array([[61.5, 0, 40.25], [0, 60.75, 30.0], [0, 0, 1]])
    hm = np.eye(4)
    hm[:3, :3] = _rotation(rs)
    hm[:3, 3] = rs.randn(3) * 0.02
    dk, rk, hm = (a.astype(np.float32) for a in (dk, rk, hm))
    d64, k64, r64 = hm.astype(np.float64), dk.astype(np.float64), \
        rk.astype(np.float64)
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    a = (u - k64[0, 2]) / k64[0, 0]
    b = (v - k64[1, 2]) / k64[1, 1]
    # u' = fx (z A + t0) / (z C + t2) + cx, with A, C per pixel
    rot, t = d64[:3, :3], d64[:3, 3]
    cA = rot[0, 0] * a + rot[0, 1] * b + rot[0, 2]
    cC = rot[2, 0] * a + rot[2, 1] * b + rot[2, 2]
    z0 = rs.uniform(0.6, 1.4, (h, w))
    u0 = r64[0, 0] * (z0 * cA + t[0]) / (z0 * cC + t[2]) + r64[0, 2]
    m = np.floor(u0) + 0.5 - r64[0, 2]          # target u' - cx
    z = (m * t[2] - r64[0, 0] * t[0]) / (r64[0, 0] * cA - m * cC)
    depth = np.where((z > 0.3) & (z < 2.0), z, 0.0).astype(np.float32)
    depth[rs.rand(h, w) < 0.05] = 0.0
    return depth, dk, rk, hm


# ------------------------------------------------------ per-pixel functions

@pytest.mark.parametrize("seed", [0, 1])
def test_filter_discontinuities_matches_jax(seed):
    rs = np.random.RandomState(seed)
    depth = rs.randint(2000, 3000, (48, 64)).astype(np.float32)
    depth[10, 12] = 9000
    depth[20:23, 25:28] = 0
    depth[30:, 40:] += 1500.5                      # a step edge
    with jax.enable_x64(False):
        want = np.asarray(jycb.filter_discontinuities(jnp.asarray(depth)))
    got = tycb.filter_discontinuities(_t(depth)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() > (depth == 0).sum()


@pytest.mark.parametrize("seed", range(4))
def test_register_depth_map_matches_jax_on_boundaries(seed):
    """Every pixel on a .5 boundary: equal to jitted JAX on every output
    pixel. The rotation's FMA contraction order decides some of them: the
    plain (uncontracted) order differs."""
    depth, dk, rk, hm = boundary_frame(seed)
    want = _jit_register(depth, dk, rk, hm, (60, 80))
    got = _register(depth, dk, rk, hm, (60, 80))
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 1000


def test_register_boundary_frames_are_decided_by_rounding(monkeypatch):
    """The boundary frames do test the rounding: spelled out without the
    FMA contractions, the pixel choice moves."""
    frames = [boundary_frame(seed) for seed in range(4)]
    want = [_register(*f, (60, 80)) for f in frames]
    monkeypatch.setattr(tycb, "lin3",
                        lambda a0, x, a1, y, a2, z: a0 * x + a1 * y + a2 * z)
    moved = sum(int((_register(*f, (60, 80)) != w_).sum())
                for f, w_ in zip(frames, want))
    assert moved > 0


@pytest.mark.parametrize("transform", ["identity_half_pixel", "rotated"])
def test_register_depth_map_matches_jax(transform):
    """Frames of the reference's oracle test, and a translation that puts
    every pixel exactly half a pixel over (z = fx t / 0.5)."""
    rs = np.random.RandomState(1)
    dk = np.array([[64.0, 0, 16], [0, 64.0, 12], [0, 0, 1]], np.float32)
    rk = dk.copy()
    hm = np.eye(4, dtype=np.float32)
    if transform == "identity_half_pixel":
        hm[:3, 3] = [1.0 / 256, -1.0 / 256, 0.0]
        depth = np.full((24, 32), 0.5, np.float32)   # 64 * (1/256) / 0.5
        depth[::3, ::2] = 0.25                       # a whole pixel over
    else:
        hm[:3, :3] = _rotation(rs, 0.2)
        hm[:3, 3] = [0.01, -0.02, 0.005]
        depth = rs.uniform(0.5, 1.5, (24, 32)).astype(np.float32)
    depth[rs.rand(24, 32) < 0.2] = 0.0
    want = _jit_register(depth, dk, rk, hm, (30, 40))
    np.testing.assert_array_equal(_register(depth, dk, rk, hm, (30, 40)),
                                  want)


def test_depth_map_to_cloud_matches_jax():
    rs = np.random.RandomState(2)
    h, w = 40, 50
    depth = rs.uniform(0.5, 1.5, (h, w)).astype(np.float32)
    depth[rs.rand(h, w) < 0.1] = 0
    rgb = rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
    k = np.array([[50.3, 0, 24.1], [0, 49.7, 19.9], [0, 0, 1]], np.float32)
    mats = []
    for _ in range(2):
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
        m[:3, 3] = rs.randn(3) * 0.1
        mats.append(m.astype(np.float32))
    with jax.enable_x64(False):
        cj, vj = jycb.depth_map_to_cloud(*(jnp.asarray(a) for a in
                                            (depth, rgb, k, *mats)))
    ct, vt = tycb.depth_map_to_cloud(*(_t(a) for a in (depth, rgb, k,
                                                       *mats)))
    cj = np.asarray(cj)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert np.all(np.abs(ct.numpy() - cj) <= 1e-6 * (1 + np.abs(cj)))


def test_writers_match_jax(tmp_path):
    cloud = np.random.RandomState(3).rand(25, 6).astype(np.float32)
    cloud[:, 3:] = (cloud[:, 3:] * 255).astype(np.uint8)
    for name, args in (("c.ply", (cloud,)), ("x.ply", (cloud[:, :3],)),
                       ("c.pcd", (cloud[:, :3],))):
        fn = "write_ply" if name.endswith("ply") else "write_pcd"
        getattr(jycb, fn)(str(tmp_path / ("j" + name)), *args)
        getattr(tycb, fn)(str(tmp_path / ("t" + name)), *args)
        assert (tmp_path / ("t" + name)).read_bytes() == \
            (tmp_path / ("j" + name)).read_bytes()


def write_frame_assets(root, obj="001_test_object", h=48, w=64,
                       rgb_hw=(60, 80), box=True):
    """One synthetic YCB frame under ``root``: a table plane at 1.2 m with
    (``box``) a box 0.3 m nearer on it, registered through a non-identity
    IR -> RGB transform into a larger RGB frame, and a rotated table pose.
    Needs h5py, imageio and PIL."""
    import h5py
    import imageio.v2 as iio
    from PIL import Image

    rgbd = os.path.join(root, obj, "rgbd")
    os.makedirs(os.path.join(rgbd, "masks"))
    os.makedirs(os.path.join(rgbd, "poses"))
    rs = np.random.RandomState(0)
    dk = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
    rk = np.array([[70.0, 0, rgb_hw[1] / 2], [0, 70.0, rgb_hw[0] / 2],
                   [0, 0, 1]])
    ir = np.eye(4)
    ir[:3, :3] = _rotation(rs, 0.02)
    ir[:3, 3] = [0.025, 0.0, 0.0]
    with h5py.File(os.path.join(rgbd, "calibration.h5"), "w") as f:
        f["NP1_depth_K"] = dk
        f["NP1_rgb_K"] = rk
        f["NP1_ir_depth_scale"] = np.array(1.0)
        f["H_NP1_from_NP5"] = np.eye(4)
        f["H_NP1_ir_from_NP5"] = ir
    with h5py.File(os.path.join(rgbd, "poses", "NP5_30_pose.h5"), "w") as f:
        t = np.eye(4)
        t[:3, :3] = _rotation(rs, 0.5)
        t[:3, 3] = [0.1, 0.0, 0.0]
        f["H_table_from_reference_camera"] = t
    depth = np.full((h, w), 12000, np.uint16)
    if box:
        depth[h // 3:2 * h // 3, w // 3:2 * w // 3] = 9000
    with h5py.File(os.path.join(rgbd, "NP1_30.h5"), "w") as f:
        f["depth"] = depth
    rgb = rs.randint(0, 255, rgb_hw + (3,)).astype(np.uint8)
    iio.imwrite(os.path.join(rgbd, "NP1_30.jpg"), rgb)
    mask = np.zeros(rgb_hw, np.uint8)
    mask[:, : rgb_hw[1] // 4] = 255
    Image.fromarray(mask).convert("RGB").save(
        os.path.join(rgbd, "masks", "NP1_30_mask.pbm"))
    return obj


@pytest.mark.parametrize("box", [False, True])
def test_generate_frame_matches_jax(tmp_path, box):
    """generate_frame end to end on synthetic YCB assets (as in
    tests/test_ycb_frame_driver.py, plus a box and non-identity
    transforms): the .npy, .pcd and .ply are the JAX package's bytes."""
    pytest.importorskip("h5py")
    pytest.importorskip("imageio.v2")
    pytest.importorskip("PIL.Image")
    obj = write_frame_assets(str(tmp_path / "j"), box=box)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    with jax.enable_x64(False):
        a = jycb.generate_frame(str(tmp_path / "j"), obj, "NP1", "30")
    b = tycb.generate_frame(str(tmp_path / "t"), obj, "NP1", "30",
                            device="cpu")
    assert os.path.relpath(a, tmp_path / "j") == os.path.relpath(
        b, tmp_path / "t")
    n = len(np.load(b))
    assert n > 500
    for ext in (".npy", ".pcd", ".ply"):
        assert open(b[:-4] + ext, "rb").read() == \
            open(a[:-4] + ext, "rb").read(), ext
    assert tycb.generate_frame(str(tmp_path / "t"), obj, "NP1", "30",
                               device="cpu") == b
    assert tycb.generate_frame(str(tmp_path), "046_plastic_bolt", "NP1",
                               "0") is None


# ------------------------------------------------------ rendering

INTR_J = jcamera.CameraIntrinsics(fx=200.0, fy=200.0, cx=32.0, cy=32.0,
                                  width=64, height=64)


def _square(z, half=0.5):
    v = np.array([[-half, -half, z], [half, -half, z], [half, half, z],
                  [-half, half, z]])
    return v, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


@pytest.mark.parametrize("scene", ["frontal", "zbuffer", "oblique"])
def test_render_mesh_matches_jax_binding(scene):
    """tests/test_render.py's scenes through both bindings: equal depth,
    shading and mask. The port's library is built under its ``_build/``."""
    if scene == "zbuffer":
        v1, f1 = _square(0.0)
        v2, f2 = _square(-1.0, half=0.05)
        v, f = np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4])
        cam = np.array([0, 0, -2.0])
    else:
        v, f = _square(0.0)
        cam = np.array([0, 0, -2.0]) if scene == "frontal" \
            else np.array([1.5, 0.0, -1.5])
    t = jcamera.look_at_pose(cam, target=[0, 0, 0], up=[0, 1, 0])
    np.testing.assert_array_equal(
        tcamera.look_at_pose(cam, target=[0, 0, 0], up=[0, 1, 0]), t)
    proj = INTR_J.k @ t[:3, :]
    got = tnative.render_mesh(proj, cam, 64, 64, v, f)
    want = jnative.render_mesh(proj, cam, 64, 64, v, f)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)
    assert got[2].sum() > 20
    lib = tnative.library_path()
    assert lib.exists() and lib.parent.name == "_build"


def test_cameras_and_random_variables_match_jax():
    cube_v, cube_t = unit_cube().vertices - 0.5, unit_cube().triangles
    intr_t = tcamera.CameraIntrinsics(**vars(INTR_J))
    vs_j = jcamera.ViewsphereDiscretizer(2.0, 2.5, 2, num_elev=2, num_az=3,
                                         num_roll=2)
    vs_t = tcamera.ViewsphereDiscretizer(2.0, 2.5, 2, num_elev=2, num_az=3,
                                         num_roll=2)
    pj, pt = vs_j.object_to_camera_poses(), vs_t.object_to_camera_poses()
    assert len(pt) == len(pj) == 24
    for (a, ca), (b, cb) in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ca, cb)
    table = (unit_cube().vertices - [0.5, 0.5, 1.0]) * [4, 4, 0.05]
    for mode in ("depth", "segmask", "color"):
        got = tcamera.VirtualCamera(intr_t).images(
            Mesh3D(cube_v, cube_t), pt[:4], mode,
            scene_objects=[tcamera.SceneObject(Mesh3D(table, cube_t),
                                               np.eye(4))])
        want = jcamera.VirtualCamera(INTR_J).images(
            JMesh3D(cube_v, cube_t), pj[:4], mode,
            scene_objects=[jcamera.SceneObject(JMesh3D(table, cube_t),
                                               np.eye(4))])
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_, w_)
    for name, kw in (("UniformViewsphereRandomVariable",
                      dict(min_radius=0.5, max_radius=0.8)),
                     ("UniformPlanarWorksurfaceRandomVariable",
                      dict(min_radius=0.5, max_radius=0.8, min_elev=0.3,
                           max_elev=1.2))):
        a = getattr(trv, name)(**kw).sample(3, np.random.RandomState(5))
        b = getattr(jrv, name)(**kw).sample(3, np.random.RandomState(5))
        for (ta, ca), (tb, cb) in zip(a, b):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(ca, cb)
    imgs = trv.RenderedImageRandomVariable(
        Mesh3D(cube_v, cube_t), intr_t,
        trv.UniformViewsphereRandomVariable(2.0, 2.5)).sample(
        2, np.random.RandomState(1))
    assert len(imgs) == 2 and all((d > 0).sum() > 20 for d in imgs)


def test_backproject_depth_matches_jax():
    verts, tris = _sphere_mesh(0.04)
    cam = tcamera.VirtualCamera(trender.DEFAULT_INTR)
    for t_wc, center in trender.view_ring(radius=0.4, n_views=3):
        depth = cam.images(Mesh3D(verts, tris), [(t_wc, center)],
                           "depth")[0]
        want = jrender.backproject_depth(depth, trender.DEFAULT_INTR.k, t_wc)
        got = trender.backproject_depth(depth, trender.DEFAULT_INTR.k, t_wc,
                                        device="cpu")
        assert got.dtype == torch.float32 and len(want) > 500
        np.testing.assert_array_equal(got.numpy(), want)


def test_render_object_clouds_matches_jax(tmp_path):
    from pointnetgpd_tpu_torch.geometry.io import write_obj

    verts, tris = _sphere_mesh()
    for side in ("j", "t"):
        gdir = tmp_path / side / "obj1" / "google_512k"
        os.makedirs(gdir)
        write_obj(str(gdir / "nontextured.obj"), verts, tris)
    a = jrender.render_object_clouds(str(tmp_path / "j" / "obj1"),
                                     n_views=3, max_points=2000, seed=3)
    b = trender.render_object_clouds(str(tmp_path / "t" / "obj1"),
                                     n_views=3, max_points=2000, seed=3,
                                     device="cpu")
    assert len(b) == len(a) == 3
    for pa, pb in zip(a, b):
        assert os.path.basename(pa) == os.path.basename(pb)
        assert open(pa, "rb").read() == open(pb, "rb").read()


# ------------------------------------------------------ card vs CPU

@pytest.mark.cuda
def test_ycb_functions_card_equal_cpu(cuda_device):
    depth, dk, rk, hm = boundary_frame(7, h=480, w=640)
    np.testing.assert_array_equal(
        _register(depth, dk, rk, hm, (1024, 1280), cuda_device),
        _register(depth, dk, rk, hm, (1024, 1280)))
    raw = (depth * 1e4).astype(np.float32)
    raw[100:140, 200:260] += 3000.0
    np.testing.assert_array_equal(
        tycb.filter_discontinuities(_t(raw, cuda_device)).cpu().numpy(),
        tycb.filter_discontinuities(_t(raw)).numpy())
    rgb = np.random.RandomState(0).randint(0, 255, (480, 640, 3))
    args = (depth, rgb.astype(np.uint8), rk, hm, hm)
    cg = tycb.depth_map_to_cloud(*(_t(a, cuda_device) for a in args))[0]
    cc = tycb.depth_map_to_cloud(*(_t(a) for a in args))[0].numpy()
    assert np.all(np.abs(cg.cpu().numpy() - cc) <= 1e-6 * (1 + np.abs(cc)))


@pytest.mark.cuda
def test_backproject_depth_card_equal_cpu(cuda_device):
    verts, tris = _sphere_mesh(0.04)
    cam = tcamera.VirtualCamera(trender.DEFAULT_INTR)
    t_wc, center = trender.view_ring(radius=0.4, n_views=1)[0]
    depth = cam.images(Mesh3D(verts, tris), [(t_wc, center)], "depth")[0]
    k = trender.DEFAULT_INTR.k
    np.testing.assert_array_equal(
        trender.backproject_depth(depth, k, t_wc, cuda_device).cpu().numpy(),
        trender.backproject_depth(depth, k, t_wc, "cpu").numpy())
