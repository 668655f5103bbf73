"""YCB RGB-D -> registered point clouds, with the per-pixel math on the card.

Port of ``pointnetgpd_tpu/pipelines/ycb_clouds.py`` (reference
PointNetGPD/ycb_cloud_generate.py): the reference's O(H*W) Python loops,
``filterDiscontinuities`` (:35-57), ``registerDepthMap`` (:60-118) and
``registeredDepthMapToPointCloud`` (:121-184), are three functions of
plain torch on the caller's device (the JAX package's are ``jnp`` under
``jit``, not Pallas kernels): a 7x7 window min/max, a back-project ->
transform -> project -> nearest-pixel scatter-max, and an elementwise
back-projection.

``register_depth_map`` picks a pixel by ``floor(...)`` of float32 values,
so it rounds as jitted JAX does on the CPU: XLA contracts the rotation's
add chain into fused multiply-adds, spelled out here with ``ops/fp.py``;
every other step is an elementwise float32 operation (a division by a
tensor, never by a host scalar, which the card turns into a reciprocal
product), so the card and the CPU give the same pixels.

The frame driver reads the files (``read_frame``: ``h5py`` and
``imageio``, imported when called), turns the arrays into a cloud
(``frame_cloud``) and writes the reference's .ply/.pcd/.npy layout under
rgbd/clouds/ (:313-374), with the NP5 reference camera, the mask, the
blacklist and ``exception.txt``. The depth is scaled in float32 (the JAX
package's own runtime, x64 off).

CLI: python -m pointnetgpd_tpu_torch.pipelines.ycb_clouds --data-root ROOT
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fp import fma, lin3

BLACK_LIST_OBJ = ["046_plastic_bolt", "063-b_marbles", "063-c_marbles",
                  "063-f_marbles"]


def _tensor(a, device, dtype=torch.float32):
    if isinstance(a, torch.Tensor):
        return a.to(device, dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def _pixel_grid(h, w, device):
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    return v, u


# ---------------------------------------------------------------------------
# Per-pixel functions
# ---------------------------------------------------------------------------

def filter_discontinuities(depth, *, filt_size: int = 7,
                           thresh: float = 1000.0):
    """Zero the depth pixels at depth discontinuities (ref :35-57): a pixel
    whose ``filt_size`` window's max or min deviates from it by more than
    ``thresh``; only the interior (whole windows) is marked, as the
    reference's offsets do (:53-55). ``depth``: (H, W) tensor."""
    off = (filt_size - 1) // 2
    d = depth.to(torch.float32)[None, None]
    maxes = F.max_pool2d(d, filt_size, stride=1)[0, 0]
    mins = -F.max_pool2d(-d, filt_size, stride=1)[0, 0]
    mids = d[0, 0, off:-off, off:-off]
    discont = torch.maximum(torch.abs(mins - mids), torch.abs(maxes - mids))
    full = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    full[off:off + discont.shape[0], off:off + discont.shape[1]] = \
        discont > thresh
    return depth * (1 - full.to(depth.dtype))


def register_depth_map(depth, depth_k, rgb_k, h_rgb_from_depth, *,
                       out_height: int, out_width: int):
    """Reproject the depth image into the RGB camera (ref :60-118): per
    pixel back-project -> transform -> project, then a nearest-pixel
    scatter keeping the largest depth per target pixel (:115-116).
    Pixels with z = 0 or outside the image go to a spare last slot.
    ``depth`` (H, W) float32 tensor; the matrices are tensors on its
    device."""
    dev = depth.device
    h, w = depth.shape
    v, u = _pixel_grid(h, w, dev)
    z = depth.to(torch.float32)
    x = (u - depth_k[0, 2]) * z / depth_k[0, 0]
    y = (v - depth_k[1, 2]) * z / depth_k[1, 1]
    r, t = h_rgb_from_depth[:3, :3], h_rgb_from_depth[:3, 3]
    # r0 x + r1 y + r2 z + t, as XLA contracts it
    xr, yr, zr = (lin3(r[i, 0], x, r[i, 1], y, r[i, 2], z) + t[i]
                  for i in range(3))
    zr_safe = torch.where(zr == 0, 1.0, zr)
    u_rgb = torch.floor(rgb_k[0, 0] * xr / zr_safe + rgb_k[0, 2] + 0.5)
    v_rgb = torch.floor(rgb_k[1, 1] * yr / zr_safe + rgb_k[1, 2] + 0.5)
    # range-check in float32 before the cast, which would wrap far pixels
    ok = ((z > 0) & (u_rgb >= 0) & (u_rgb < out_width) & (v_rgb >= 0)
          & (v_rgb < out_height))
    spare = out_height * out_width
    flat = torch.where(ok, v_rgb.clamp(0, out_height - 1).long() * out_width
                       + u_rgb.clamp(0, out_width - 1).long(), spare)
    vals = torch.where(ok, zr, -torch.inf)
    registered = torch.zeros((spare + 1,), dtype=torch.float32, device=dev)
    registered.scatter_reduce_(0, flat.reshape(-1), vals.reshape(-1), "amax",
                               include_self=True)
    return registered[:-1].reshape(out_height, out_width)


def depth_map_to_cloud(depth_map, rgb_image, rgb_k, ref_from_rgb,
                       obj_from_ref):
    """Back-project a registered depth map into the object (table) frame
    (ref :121-184). Returns ((H*W, 6) xyzrgb rows, (H*W,) valid mask); the
    reference's compaction to valid pixels is a mask on the host."""
    h, w = depth_map.shape
    v, u = _pixel_grid(h, w, depth_map.device)
    z = depth_map.to(torch.float32)
    x = (u - rgb_k[0, 2]) * z / rgb_k[0, 0]
    y = (v - rgb_k[1, 2]) * z / rgb_k[1, 1]
    p = (x.reshape(-1), y.reshape(-1), z.reshape(-1))
    for m in (ref_from_rgb, obj_from_ref):          # p @ R.T + t, twice
        p = tuple(fma(m[i, 2], p[2], fma(m[i, 1], p[1], p[0] * m[i, 0]))
                  + m[i, 3] for i in range(3))
    rgb = rgb_image.reshape(-1, rgb_image.shape[-1])[:, :3].to(torch.float32)
    cloud = torch.cat([torch.stack(p, dim=1), rgb], dim=1)
    return cloud, (z > 0).reshape(-1)


# ---------------------------------------------------------------------------
# Host IO + frame driver (reference layout, :313-374)
# ---------------------------------------------------------------------------

def write_ply(filename, cloud_xyzrgb):
    """ASCII PLY in the reference's layout (:187-230)."""
    n = len(cloud_xyzrgb)
    color = cloud_xyzrgb.shape[1] == 6
    header = ["ply", "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if color:
        header += ["property uchar diffuse_red",
                   "property uchar diffuse_green",
                   "property uchar diffuse_blue"]
    header += ["end_header"]
    with open(filename, "w") as f:
        f.write("\n".join(header) + "\n")
        for row in cloud_xyzrgb:
            xyz = " ".join(f"{v:f}" for v in row[:3])
            if color:
                f.write(xyz + " " + " ".join(str(int(c)) for c in row[3:6])
                        + "\n")
            else:
                f.write(xyz + "\n")


def write_pcd(filename, cloud_xyz):
    """Binary PCD (xyz float32), the reference's writePCD (:233-300)."""
    n = len(cloud_xyz)
    header = "\n".join([
        "# .PCD v.7 - Point Cloud Data file format",
        "VERSION .7", "FIELDS x y z", "SIZE 4 4 4", "TYPE F F F",
        "COUNT 1 1 1", f"WIDTH {n}", "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0", f"POINTS {n}", "DATA binary", ""])
    with open(filename, "wb") as f:
        f.write(header.encode())
        cloud_xyz.astype(np.float32).tofile(f)


def read_frame(rgbd: str, viewpoint_camera: str, viewpoint_angle: str,
               reference_camera: str = "NP5"):
    """The arrays of one YCB RGB-D frame under ``rgbd`` (calibration, pose,
    depth .h5, .jpg and the .pbm mask), as ``frame_cloud``'s keyword
    arguments; None where the calibration lacks the camera."""
    import h5py

    try:
        from imageio.v2 import imread
    except ImportError:  # pragma: no cover
        from imageio import imread

    cam, ref = viewpoint_camera, reference_camera
    basename = f"{cam}_{viewpoint_angle}"
    with h5py.File(os.path.join(rgbd, "calibration.h5"), "r") as cal:
        if f"{cam}_depth_K" not in cal:
            return None
        depth_k = cal[f"{cam}_depth_K"][:]
        rgb_k = cal[f"{cam}_rgb_K"][:]
        depth_scale = np.array(cal[f"{cam}_ir_depth_scale"]) * 1e-4
        rgb_from_ref = cal[f"H_{cam}_from_{ref}"][:]
        ir_from_ref = cal[f"H_{cam}_ir_from_{ref}"][:]
    with h5py.File(os.path.join(rgbd, "poses",
                                f"{ref}_{viewpoint_angle}_pose.h5"),
                   "r") as f:
        obj_from_ref = f["H_table_from_reference_camera"][:]
    with h5py.File(os.path.join(rgbd, basename + ".h5"), "r") as f:
        depth = f["depth"][:]
    return dict(
        depth=depth, depth_k=depth_k, rgb_k=rgb_k, depth_scale=depth_scale,
        h_rgb_from_depth=rgb_from_ref @ np.linalg.inv(ir_from_ref),
        ref_from_rgb=np.linalg.inv(rgb_from_ref), obj_from_ref=obj_from_ref,
        rgb_image=imread(os.path.join(rgbd, basename + ".jpg")),
        mask=imread(os.path.join(rgbd, "masks",
                                 basename + "_mask.pbm"))[:, :, 0])


def frame_cloud(depth, depth_k, rgb_k, depth_scale, h_rgb_from_depth,
                ref_from_rgb, obj_from_ref, rgb_image, mask, device="cuda"):
    """One frame's arrays -> its (N, 6) float32 xyzrgb cloud (numpy) in the
    object frame: filter, scale, register into the RGB camera, zero the
    masked pixels (mask 255), back-project, keep the valid pixels. The
    per-pixel work runs on ``device``; the 4x4 matrices are float64 on the
    host and enter as float32."""
    dev = torch.device(device)
    f32 = [_tensor(np.asarray(a, np.float64).astype(np.float32), dev)
           for a in (depth_k, rgb_k, h_rgb_from_depth, ref_from_rgb,
                     obj_from_ref)]
    depth_k, rgb_k, h_rgb_from_depth, ref_from_rgb, obj_from_ref = f32
    depth = filter_discontinuities(_tensor(
        np.asarray(depth).astype(np.float32), dev))
    # float32 depth x float64 scale, rounded to float32 (as numpy computes
    # it and JAX's x64-off runtime takes it)
    depth = (depth.to(torch.float64) * float(np.asarray(depth_scale))).to(
        torch.float32)
    rgb_image = np.asarray(rgb_image)
    registered = register_depth_map(
        depth, depth_k, rgb_k, h_rgb_from_depth,
        out_height=rgb_image.shape[0], out_width=rgb_image.shape[1])
    registered = torch.where(_tensor(np.asarray(mask) == 255, dev,
                                     torch.bool), 0.0, registered)
    cloud, valid = depth_map_to_cloud(registered, _tensor(rgb_image, dev),
                                      rgb_k, ref_from_rgb, obj_from_ref)
    return cloud[valid].cpu().numpy()


def generate_frame(ycb_data_folder: str, target_object: str,
                   viewpoint_camera: str, viewpoint_angle: str,
                   reference_camera: str = "NP5", overwrite: bool = False,
                   device="cuda"):
    """One RGB-D frame -> rgbd/clouds/pc_{cam}_{ref}_{angle}.ply/.pcd/.npy
    (ref generate(), :313-374); returns the .npy path, or None for a
    blacklisted object or a camera the calibration lacks. Needs the YCB
    rgbd assets (h5/jpg/pbm) on disk."""
    if target_object in BLACK_LIST_OBJ:
        return None
    rgbd = os.path.join(ycb_data_folder, target_object, "rgbd")
    clouds_dir = os.path.join(rgbd, "clouds")
    os.makedirs(clouds_dir, exist_ok=True)
    stem = f"pc_{viewpoint_camera}_{reference_camera}_{viewpoint_angle}"
    npy_fname = os.path.join(clouds_dir, stem + ".npy")
    if os.path.exists(npy_fname) and not overwrite:
        return npy_fname
    frame = read_frame(rgbd, viewpoint_camera, viewpoint_angle,
                       reference_camera)
    if frame is None:
        return None
    cloud = frame_cloud(**frame, device=device)
    write_ply(os.path.join(clouds_dir, stem + ".ply"), cloud)
    write_pcd(os.path.join(clouds_dir, stem + ".pcd"), cloud[:, :3])
    np.save(npy_fname, cloud[:, :3])
    return npy_fname


def main(argv=None):
    import argparse
    import glob

    p = argparse.ArgumentParser(description="YCB RGB-D -> point clouds")
    p.add_argument("--data-root",
                   default=os.environ.get("PointNetGPD_FOLDER", ""))
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    folder = os.path.join(args.data_root, "data/ycb-tools/models/ycb")
    # failed frames are appended to exception.txt, like the reference's
    # bad-frame log (PointNetGPD/exception.txt)
    exc_path = os.path.join(args.data_root or ".", "exception.txt")
    jpgs = sorted(glob.glob(f"{folder}/*/rgbd/*.jpg"))
    if not jpgs:
        p.error(
            f"no RGB-D frames under {folder!r}: point --data-root (or "
            "$PointNetGPD_FOLDER) at the reference's YCB layout")
    for jpg in jpgs:
        parts = jpg.split("/")
        obj = parts[-3]
        cam, angle = os.path.basename(jpg).split(".")[0].split("_")
        try:
            out = generate_frame(folder, obj, cam, angle,
                                 overwrite=args.overwrite, device=args.device)
            if out is None:
                raise ValueError("missing calibration or blacklisted")
        except Exception as e:
            with open(exc_path, "a") as f:
                f.write(f"{jpg}: {e}\n")
    print(f"All {len(jpgs)} frames done.")


if __name__ == "__main__":
    main()
