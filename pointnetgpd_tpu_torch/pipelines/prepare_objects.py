"""Batch object preprocessing: meshes -> cleaned OBJ + SDF.

Port of ``pointnetgpd_tpu/pipelines/prepare_objects.py`` (reference:
dex-net/apps/read_file_sdf.py:34-73, which shells out to ``pcl_ply2obj`` and
the external SDFGen binary over every YCB object): one process drives the
voxelizer (``ops/mesh_to_sdf.py``, kernel K3 on CUDA); PLY conversion is
native instead of pcl-tools.

    python -m pointnetgpd_tpu_torch.pipelines.prepare_objects \
        --data-root DIR [--sdf-dim 100] [--sdf-padding 5] [--overwrite] \
        [--device cuda]
"""

from __future__ import annotations

import os

import numpy as np


def read_ply_mesh(path: str):
    """Minimal ASCII-PLY mesh reader (vertex + face elements) — replaces the
    pcl_ply2obj shell-out (read_file_sdf.py:54)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        if not any("format ascii" in h for h in header):
            raise ValueError(f"{path}: only ascii PLY supported")
        n_verts = n_faces = 0
        for h in header:
            if h.startswith("element vertex"):
                n_verts = int(h.split()[-1])
            elif h.startswith("element face"):
                n_faces = int(h.split()[-1])
        verts = np.array([
            [float(x) for x in f.readline().split()[:3]]
            for _ in range(n_verts)
        ])
        faces = []
        for _ in range(n_faces):
            parts = [int(x) for x in f.readline().split()]
            n, idx = parts[0], parts[1:]
            for k in range(1, n - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
    return verts, np.asarray(faces, np.int32)


def prepare_object_dir(obj_dir: str, *, sdf_dim: int = 100,
                       sdf_padding: int = 5, overwrite: bool = False,
                       device="cuda"):
    """Process one YCB object dir (google_512k/nontextured.{ply,obj} ->
    nontextured.sdf), reference layout (read_file_sdf.py:34-56)."""
    from ..geometry.io import read_obj, write_obj, write_sdf
    from ..geometry.mesh import Mesh3D
    from ..ops.mesh_to_sdf import mesh_to_sdf

    gdir = os.path.join(obj_dir, "google_512k")
    obj_path = os.path.join(gdir, "nontextured.obj")
    ply_path = os.path.join(gdir, "nontextured.ply")
    sdf_path = os.path.join(gdir, "nontextured.sdf")
    if os.path.exists(sdf_path) and not overwrite:
        return sdf_path
    if os.path.exists(obj_path):
        v, fcs = read_obj(obj_path)
    elif os.path.exists(ply_path):
        v, fcs = read_ply_mesh(ply_path)
        write_obj(obj_path, v, fcs)
    else:
        return None
    mesh = Mesh3D(v, fcs).remove_bad_tris().remove_unreferenced_vertices()
    sdf = mesh_to_sdf(mesh, dim=sdf_dim, padding=sdf_padding, device=device)
    write_sdf(sdf_path, sdf)
    return sdf_path


def main(argv=None):
    import argparse
    import glob

    p = argparse.ArgumentParser(description="mesh -> obj+sdf preprocessing")
    p.add_argument("--data-root",
                   default=os.environ.get("PointNetGPD_FOLDER", ""))
    p.add_argument("--sdf-dim", type=int, default=100)
    p.add_argument("--sdf-padding", type=int, default=5)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = os.path.join(args.data_root, "PointNetGPD/data/ycb-tools/models/ycb")
    obj_dirs = sorted(glob.glob(f"{root}/*/"))
    if not obj_dirs:
        p.error(
            f"no object directories under {root!r} — point --data-root (or "
            "$PointNetGPD_FOLDER) at the reference's YCB layout")
    for obj_dir in obj_dirs:
        out = prepare_object_dir(obj_dir, sdf_dim=args.sdf_dim,
                                 sdf_padding=args.sdf_padding,
                                 overwrite=args.overwrite, device=args.device)
        print(obj_dir, "->", out)


if __name__ == "__main__":
    main()
