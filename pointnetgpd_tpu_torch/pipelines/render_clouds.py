"""Per-view point clouds rendered from object meshes (no RGB-D captures).

The reference's cloud stage converts real YCB RGB-D frames into per-view
object-frame clouds (reference: PointNetGPD/ycb_cloud_generate.py:313-381;
that path is ported in pipelines/ycb_clouds.py). When the dataset is
synthetic meshes (or YCB RGB-D captures are unavailable), this module stands
in: render depth images with the native renderer (native/renderer — the
meshrender replacement, meshpy/meshpy/mesh_renderer.py:492) from a ring of
oblique viewpoints, backproject into the object frame, and write the
reference's cloud layout ``{obj}/rgbd/clouds/pc_NP3_NP5_{v}.npy``
(model/dataset.py:226-227,400 expects exactly this glob).

Port of ``pointnetgpd_tpu/pipelines/render_clouds.py``. The rasterizer
runs on the host (``render/native.py``), as in the JAX package;
``backproject_depth`` runs on ``device`` (the card by default). The
subsample and the sensor noise are drawn on the host from the same numpy
``RandomState`` as in the JAX package, so the files are the same.

CLI: python -m pointnetgpd_tpu_torch.pipelines.render_clouds --data-root ROOT
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry.mesh import Mesh3D
from ..render.camera import (CameraIntrinsics, RenderMode, VirtualCamera,
                             look_at_pose)

DEFAULT_INTR = CameraIntrinsics(fx=520.0, fy=520.0, cx=160.0, cy=120.0,
                                width=320, height=240)


def backproject_depth(depth, k, t_world_camera, device="cuda"):
    """Depth image (H, W) -> (N, 3) float32 world-frame points on
    ``device``, row-major over the pixels with depth > 0 (the inverse of
    the renderer's ``proj = K @ T[:3, :]``; ycb_cloud_generate.py:121-184
    does the same reprojection from registered RGB-D). Computed in float64
    as the JAX package's numpy does: K's back substitution with reciprocals
    (as LAPACK's solve), then R^T (p - t); elementwise, so the card and the
    CPU give the same bits."""
    dev = torch.device(device)
    depth = torch.as_tensor(np.asarray(depth) if not isinstance(
        depth, torch.Tensor) else depth).to(dev)
    k = torch.as_tensor(np.asarray(k, np.float64), device=dev)
    t_wc = torch.as_tensor(np.asarray(t_world_camera, np.float64),
                           device=dev)
    vv, uu = torch.nonzero(depth > 0, as_tuple=True)
    d = depth[vv, uu].to(torch.float64)
    # K^-1 [u + 0.5, v + 0.5, 1] (pixel centers) by back substitution
    z = 1.0 / k[2, 2] + torch.zeros_like(d)
    y = (vv.to(torch.float64) + 0.5 - k[1, 2] * z) * (1.0 / k[1, 1])
    x = ((uu.to(torch.float64) + 0.5 - k[0, 2] * z) - k[0, 1] * y) \
        * (1.0 / k[0, 0])
    p = [x * d - t_wc[0, 3], y * d - t_wc[1, 3], z * d - t_wc[2, 3]]
    r = t_wc[:3, :3]
    return torch.stack([(p[0] * r[0, j] + p[1] * r[1, j]) + p[2] * r[2, j]
                        for j in range(3)], dim=1).to(torch.float32)


def view_ring(radius: float = 0.45, n_views: int = 6,
              elevation: float = 0.32):
    """Oblique camera ring (a straight-overhead camera sees almost no side
    points — docs/QUIRKS.md GPG note)."""
    poses = []
    for v in range(n_views):
        th = 2 * np.pi * v / n_views + 0.37
        c = np.array([radius * np.cos(th), radius * np.sin(th), elevation])
        poses.append((look_at_pose(c, target=[0, 0, 0], up=[0, 0, 1.0]), c))
    return poses


def render_object_clouds(obj_dir: str, *, n_views: int = 6,
                         intr: CameraIntrinsics = DEFAULT_INTR,
                         noise_std: float = 3e-4, seed: int = 0,
                         max_points: int | None = None,
                         overwrite: bool = False, device="cuda"):
    """One object dir (reference layout {obj}/google_512k/nontextured.obj):
    render ``n_views`` depth views, backproject on ``device``, add
    sub-voxel sensor noise, write {obj}/rgbd/clouds/pc_NP3_NP5_{v}.npy.
    Returns the cloud paths."""
    from ..geometry.io import read_obj

    obj_path = os.path.join(obj_dir, "google_512k", "nontextured.obj")
    if not os.path.exists(obj_path):
        return []
    cloud_dir = os.path.join(obj_dir, "rgbd", "clouds")
    os.makedirs(cloud_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    verts, faces = read_obj(obj_path)
    mesh = Mesh3D(verts, faces)
    cam = VirtualCamera(intr)
    out = []
    for v, (t_wc, center) in enumerate(view_ring(n_views=n_views)):
        path = os.path.join(cloud_dir, f"pc_NP3_NP5_{v}.npy")
        if os.path.exists(path) and not overwrite:
            out.append(path)
            continue
        depth = cam.images(mesh, [(t_wc, center)], RenderMode.DEPTH)[0]
        pts = backproject_depth(depth, intr.k, t_wc, device).cpu().numpy()
        if len(pts) == 0:
            continue
        if max_points and len(pts) > max_points:
            pts = pts[rng.choice(len(pts), max_points, replace=False)]
        pts = pts + rng.randn(*pts.shape).astype(np.float32) * noise_std
        np.save(path, pts.astype(np.float32))
        out.append(path)
    return out


def main(argv=None):
    import argparse
    import glob

    p = argparse.ArgumentParser(
        description="render per-view clouds from object meshes")
    p.add_argument("--data-root",
                   default=os.environ.get("PointNetGPD_FOLDER", ""))
    p.add_argument("--n-views", type=int, default=6)
    p.add_argument("--noise-std", type=float, default=3e-4)
    p.add_argument("--max-points", type=int, default=40000)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = os.path.join(args.data_root,
                        "PointNetGPD/data/ycb-tools/models/ycb")
    obj_dirs = sorted(glob.glob(f"{root}/*/"))
    if not obj_dirs:
        p.error(f"no object dirs under {root!r}")
    for i, obj_dir in enumerate(obj_dirs):
        paths = render_object_clouds(
            obj_dir, n_views=args.n_views, noise_std=args.noise_std,
            max_points=args.max_points, seed=i, overwrite=args.overwrite,
            device=args.device)
        print(obj_dir, "->", len(paths), "views")


if __name__ == "__main__":
    main()
