"""GQ-CNN-style rendered-image dataset generation.

Port of ``pointnetgpd_tpu/pipelines/gqcnn_dataset.py``. Re-design of the
reference tool (reference: dex-net/tools/generate_gqcnn_dataset.py —
renders depth images of database objects in their stable poses on a table,
transforms the stored parallel-jaw grasps into image space, and writes
grasp-centric training tensors): the renderer is the repository's native
rasterizer (``render/native.py``, built into the port's ``_build/``), grasp
projection and the aligned crop are batched numpy, and storage is the
chunked TensorDataset (``learning/tensor_dataset.py``). All of it is host
work, in the JAX package as here, so the files are the same.

Per datapoint: a depth crop centered+aligned on the grasp, the hand pose
(u, v, depth, angle), and the stored quality metrics.

CLI: python -m pointnetgpd_tpu_torch.pipelines.gqcnn_dataset DB DATASET OUT
"""

from __future__ import annotations

import numpy as np

from ..learning.tensor_dataset import TensorDataset
from ..render.camera import (CameraIntrinsics, RenderMode,
                             ViewsphereDiscretizer, VirtualCamera)


def project_grasps_to_image(configs, t_world_camera, intr: CameraIntrinsics):
    """(G, >=10) grasp configurations -> image-space grasps.

    Returns (u, v, depth, angle) per grasp: pixel center, camera-frame depth,
    and the grasp-axis angle in the image plane (the reference's
    Grasp2D fields, grasp.py:820-870)."""
    configs = np.asarray(configs)
    centers = configs[:, 0:3]
    axes = configs[:, 3:6]
    rot, t = t_world_camera[:3, :3], t_world_camera[:3, 3]
    c_cam = centers @ rot.T + t
    a_cam = axes @ rot.T
    depth = c_cam[:, 2]
    u = intr.fx * c_cam[:, 0] / depth + intr.cx
    v = intr.fy * c_cam[:, 1] / depth + intr.cy
    angle = np.arctan2(a_cam[:, 1], a_cam[:, 0])
    return u, v, depth, angle


def extract_aligned_crop(depth_im, u, v, angle, crop_size: int = 96,
                         out_size: int = 32):
    """Rotate the image so the grasp axis is horizontal, crop around the
    grasp center, and downsample — the GQ-CNN input convention."""
    h, w = depth_im.shape
    half = crop_size // 2
    # rotation by -angle about (u, v) with bilinear sampling
    yy, xx = np.meshgrid(np.arange(out_size), np.arange(out_size),
                         indexing="ij")
    scale = crop_size / out_size
    xs = (xx - out_size / 2 + 0.5) * scale
    ys = (yy - out_size / 2 + 0.5) * scale
    ca, sa = np.cos(angle), np.sin(angle)
    src_x = u + ca * xs - sa * ys
    src_y = v + sa * xs + ca * ys
    x0 = np.clip(np.floor(src_x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(src_y).astype(int), 0, h - 2)
    fx = np.clip(src_x - x0, 0, 1)
    fy = np.clip(src_y - y0, 0, 1)
    d = depth_im
    crop = ((1 - fx) * (1 - fy) * d[y0, x0] + fx * (1 - fy) * d[y0, x0 + 1]
            + (1 - fx) * fy * d[y0 + 1, x0] + fx * fy * d[y0 + 1, x0 + 1])
    return crop.astype(np.float32)


def generate_gqcnn_dataset(dataset, output_dir: str, *,
                           gripper_name: str = "robotiq_85",
                           metric_name: str = "robust_ferrari_canny",
                           intr: CameraIntrinsics | None = None,
                           num_radii: int = 1, num_elev: int = 2,
                           num_az: int = 4, min_radius: float = 0.5,
                           max_radius: float = 0.7, im_size: int = 32,
                           crop_size: int = 96,
                           datapoints_per_file: int = 100):
    """Render + project every object's stored grasps into a TensorDataset.

    dataset: an opened Hdf5Dataset with meshes, stable poses, and grasps.
    Output fields: depth_ims_tf_table (im, im, 1), hand_poses (4,), metrics (1,).
    """
    intr = intr or CameraIntrinsics(fx=320.0, fy=320.0, cx=64.0, cy=64.0,
                                    width=128, height=128)
    cam = VirtualCamera(intr)
    vs = ViewsphereDiscretizer(min_radius, max_radius, num_radii,
                               num_elev=num_elev, num_az=num_az)

    out = TensorDataset(output_dir, {
        "depth_ims_tf_table": {"shape": [im_size, im_size, 1],
                               "dtype": "float32"},
        "hand_poses": {"shape": [4], "dtype": "float32"},
        "metrics": {"shape": [], "dtype": "float32"},
        "obj_ids": {"shape": [], "dtype": "int64"},
    }, datapoints_per_file)

    for obj_id, key in enumerate(dataset.object_keys):
        if not dataset.has_grasps(key, gripper_name):
            continue
        mesh = dataset.mesh(key)
        configs = dataset.grasps(key, gripper_name)
        stored = dataset.grasp_metrics(key, gripper_name)
        if metric_name not in stored:
            # a typo'd metric name must not silently write all-zero labels
            raise KeyError(
                f"object {key!r} has no grasp metric {metric_name!r}; "
                f"stored metrics: {sorted(stored)}")
        metrics = stored[metric_name]
        try:
            poses = dataset.stable_poses(key)[:1]  # most probable pose
        except KeyError:
            poses = [{"r": np.eye(3), "x0": np.zeros(3)}]

        for pose in poses:
            t_stp = np.eye(4)
            t_stp[:3, :3] = pose["r"]
            mesh_stp = mesh.transform(t_stp)
            cfg_stp = configs.copy()
            cfg_stp[:, 0:3] = configs[:, 0:3] @ pose["r"].T
            cfg_stp[:, 3:6] = configs[:, 3:6] @ pose["r"].T

            for t_wc, center in vs.object_to_camera_poses():
                depth_im = cam.images(mesh_stp, [(t_wc, center)],
                                      RenderMode.DEPTH)[0]
                us, vs_, ds, angs = project_grasps_to_image(cfg_stp, t_wc, intr)
                for g in range(len(cfg_stp)):
                    if not (0 <= us[g] < intr.width and 0 <= vs_[g] < intr.height
                            and ds[g] > 0):
                        continue
                    crop = extract_aligned_crop(depth_im, us[g], vs_[g],
                                                angs[g], crop_size, im_size)
                    dp = out.datapoint_template()
                    dp["depth_ims_tf_table"] = crop[..., None]
                    dp["hand_poses"] = np.array(
                        [us[g], vs_[g], ds[g], angs[g]], np.float32)
                    dp["metrics"] = np.float32(metrics[g])
                    dp["obj_ids"] = np.int64(obj_id)
                    out.add(dp)
    out.flush()
    return out


def main(argv=None):
    """CLI counterpart of the reference's tools/generate_gqcnn_dataset.py:
    render every stored grasp of an HDF5 database into a TensorDataset."""
    import argparse

    from ..database.hdf5 import Hdf5Database

    p = argparse.ArgumentParser(
        description="render HDF5 database grasps into a GQ-CNN TensorDataset")
    p.add_argument("database", help="HDF5 database path")
    p.add_argument("dataset", help="dataset name inside the database")
    p.add_argument("output_dir")
    p.add_argument("--gripper", default="robotiq_85")
    p.add_argument("--metric", default="robust_ferrari_canny")
    p.add_argument("--im-size", type=int, default=32)
    args = p.parse_args(argv)

    db = Hdf5Database(args.database)
    try:
        ds = db.dataset(args.dataset)
        out = generate_gqcnn_dataset(ds, args.output_dir,
                                     gripper_name=args.gripper,
                                     metric_name=args.metric,
                                     im_size=args.im_size)
        print(f"wrote {out.num_datapoints} datapoints to {args.output_dir}")
    finally:
        db.close()
    return 0


if __name__ == "__main__":
    main()
