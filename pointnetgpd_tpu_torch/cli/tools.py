"""Diagnostic/visualization tools: the reference's small apps.

Port of ``pointnetgpd_tpu/cli/tools.py``. Equivalents of (reference paths):
- dex-net/apps/Cal_norm.py:72-152      -> ``compare_normals`` (SDF vs KNN
  normal estimates, rendered side by side)
- dex-net/apps/read_grasps_from_file.py:22-80 -> ``show_grasp_file``
  (visualize generated grasp .npy files on the object mesh)
- dex-net/apps/show_pcd.py:18-52       -> ``show_clouds`` (overlay view
  clouds on the object mesh)
All plots are matplotlib PNGs (mayavi absent). The normals of
``compare_normals`` are computed on ``--device`` (the card by default); the
rest is host work.

Usage: python -m pointnetgpd_tpu_torch.cli.tools compare-normals SDF OUT
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch


def sdf_and_knn_normals(sdf_path: str, n_points: int = 300, seed: int = 0,
                        device="cuda"):
    """The two normal estimates of ``compare_normals`` on ``device``: a
    ``RandomState(seed)`` subset of the SDF's surface cells, their world
    points, the SDF plane-fit normals and the KNN normals of those points.
    Returns host arrays (idx, pts, n_sdf, valid, n_knn)."""
    from ..geometry.io import read_sdf
    from ..geometry.sdf import surface_normal
    from ..ops.cloud import estimate_normals_knn

    sdf = read_sdf(sdf_path, device=device)
    rng = np.random.RandomState(seed)
    idx = rng.choice(sdf.surface_points.shape[0],
                     min(n_points, sdf.surface_points.shape[0]),
                     replace=False)
    pts_grid = sdf.surface_points[torch.as_tensor(idx,
                                                  device=sdf.data.device)]
    # origin + res * grid, rounded twice as the JAX package's eager code
    # computes it (``geometry/sdf.py grid_to_world`` is one FMA)
    pts = sdf.origin + sdf.resolution * pts_grid
    n_sdf, valid = surface_normal(sdf, pts_grid)
    pts_np = pts.cpu().numpy()
    cam = pts_np.mean(axis=0) + np.array([0, 0, 1.0])
    n_knn = estimate_normals_knn(
        pts, torch.as_tensor(cam, dtype=torch.float32, device=pts.device),
        k=min(30, len(pts_np) - 1))
    return (idx, pts_np, n_sdf.cpu().numpy(), valid.cpu().numpy(),
            n_knn.cpu().numpy())


def compare_normals(sdf_path: str, out_png: str, n_points: int = 300,
                    seed: int = 0, device="cuda"):
    """SDF surface normals (plane fit) vs KNN-estimated normals from the
    surface points — the Cal_norm meshpy-vs-pcl comparison."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, pts, n_sdf, _, n_knn = sdf_and_knn_normals(sdf_path, n_points, seed,
                                                  device)

    fig = plt.figure(figsize=(12, 6))
    for i, (n, title) in enumerate([(n_sdf, "SDF plane-fit normals"),
                                    (n_knn, "KNN-estimated normals")]):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        ax.scatter(*pts.T, s=2, c="b")
        ax.quiver(*pts.T, *(0.01 * n).T, color="r", linewidth=0.5)
        ax.set_title(title)
    fig.savefig(out_png, dpi=100)
    # agreement statistic (up to sign)
    cos = np.abs(np.sum(n_sdf * n_knn, axis=1))
    print(f"normal agreement |cos|: mean={cos.mean():.3f} "
          f"p10={np.quantile(cos, 0.1):.3f}")
    return out_png


def show_grasp_file(grasp_npy: str, obj_path: str, out_png: str,
                    max_plot: int = 25):
    """Visualize a generated grasp .npy (12-col rows) on the object mesh."""
    from ..geometry.io import read_obj
    from ..geometry.mesh import Mesh3D
    from ..visualization import plot_grasps_3d

    rows = np.load(grasp_npy)
    v, f = read_obj(obj_path)
    fig = plot_grasps_3d(Mesh3D(v, f), rows[:, :10], scores=rows[:, 11],
                         max_plot=max_plot)
    fig.savefig(out_png, dpi=100)
    print(f"{len(rows)} grasps; friction classes "
          f"{sorted(set(np.round(rows[:, 10], 2)))} -> {out_png}")
    return out_png


def show_clouds(clouds_glob: str, out_png: str, obj_path: str | None = None,
                max_points: int = 20000, seed: int = 0):
    """Overlay view clouds (rgbd/clouds/*.npy) and optionally the mesh."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    files = sorted(glob.glob(clouds_glob))
    if not files:
        raise FileNotFoundError(clouds_glob)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    rng = np.random.RandomState(seed)
    for path in files[:8]:
        pc = np.load(path)[:, :3]
        if len(pc) > max_points // len(files[:8]):
            pc = pc[rng.choice(len(pc), max_points // len(files[:8]),
                               replace=False)]
        ax.scatter(*pc.T, s=1, alpha=0.4, label=os.path.basename(path))
    if obj_path:
        from ..geometry.io import read_obj
        from ..geometry.mesh import Mesh3D
        from ..visualization import plot_mesh

        v, f = read_obj(obj_path)
        plot_mesh(Mesh3D(v, f), ax=ax, alpha=0.2)
    ax.legend(fontsize=6)
    fig.savefig(out_png, dpi=100)
    return out_png


def visualize_gqcnn_dataset(dataset_dir: str, out_png: str,
                            num_samples: int = 16, seed: int = 0):
    """Grid of grasp-centric depth crops with their metrics
    (reference: dex-net/tools/visualize_gqcnn_dataset.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..learning.tensor_dataset import TensorDataset

    ds = TensorDataset.open(dataset_dir)
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(ds), min(num_samples, len(ds)), replace=False)
    cols = 4
    rows = (len(idx) + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    for ax, i in zip(np.atleast_1d(axes).ravel(), idx):
        dp = ds.datapoint(int(i))
        ax.imshow(dp["depth_ims_tf_table"][..., 0], cmap="gray")
        ax.set_title(f"q={float(dp['metrics']):.3f}", fontsize=8)
        ax.axis("off")
    fig.savefig(out_png, dpi=100)
    print(f"{len(idx)} samples from {len(ds)} -> {out_png}")
    return out_png


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="diagnostic tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device of compare-normals (default: cuda)")
    c1 = sub.add_parser("compare-normals")
    c1.add_argument("sdf"), c1.add_argument("out")
    c2 = sub.add_parser("show-grasps")
    c2.add_argument("grasp_npy"), c2.add_argument("obj"), c2.add_argument("out")
    c3 = sub.add_parser("show-clouds")
    c3.add_argument("clouds_glob"), c3.add_argument("out")
    c3.add_argument("--obj", default=None)
    c4 = sub.add_parser("visualize-gqcnn")
    c4.add_argument("dataset_dir"), c4.add_argument("out")
    args = p.parse_args(argv)
    if args.cmd == "compare-normals":
        compare_normals(args.sdf, args.out, device=args.device)
    elif args.cmd == "show-grasps":
        show_grasp_file(args.grasp_npy, args.obj, args.out)
    elif args.cmd == "visualize-gqcnn":
        visualize_gqcnn_dataset(args.dataset_dir, args.out)
    else:
        show_clouds(args.clouds_glob, args.out, args.obj)


if __name__ == "__main__":
    main()
