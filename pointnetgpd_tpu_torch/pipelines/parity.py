"""Training-accuracy parity harness: the port's trainer vs the reference's.

Port of ``pointnetgpd_tpu/pipelines/parity.py``. The reference's purpose is
the trained classifier (reference: PointNetGPD/main_1v_mc.py:59-110 train
and test loops over PointGraspOneViewMultiClassDataset,
model/dataset.py:464-549). This module:

1. generates a labeled grasp dataset with the port's own labeling path
   (antipodal sampling + friction-ladder labels + Ferrari-Canny,
   ``pipelines/generate_dataset.py``) on analytic and mesh-backed objects
   (the latter voxelized by ``ops.mesh_to_sdf``, kernel K3 on the card),
   written in the reference's on-disk layout ($PointNetGPD_FOLDER tree:
   ycb_grasp/{tag}/*.npy 12-col rows + per-view clouds + google2cloud.pkl,
   dataset.py:12,226-227,400);
2. trains the REFERENCE torch path on it — its own dataset class and model
   code imported from a reference checkout (oracle only), driven by a loop
   with main_1v_mc.py's semantics (Adam(lr) re-created every epoch, NLL on
   log_softmax, per-epoch eval in eval mode, main_1v.py:59-110);
3. trains the port's path (OneViewBatcher + fused train step; the eval
   pass's trunks through kernel K2 on the card) on the identical files with
   the same batch/lr/epochs and the same optimizer-reset quirk;
4. compares per-epoch eval accuracy.

Draws: object i labels under ``Draws(seed + 17 * i)`` (the JAX package's
``PRNGKey(seed + 17 * i)``) unless ``draws_for_object`` gives another
source; ``train_ours`` takes one source whose ``next_round()`` gives each
train step's crop draws and, once per epoch, the eval pass's (whose
``next_round()`` gives each eval batch's), in the order of the JAX
package's key splits. The numpy ``RandomState``s are the JAX package's.
"""

from __future__ import annotations

import os
import pickle
import sys
import types

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Analytic objects: SDF grids + dense surface samplers
# ---------------------------------------------------------------------------


def _sdf_grid_from_fn(fn, half_extent: float, dim: int, resolution: float,
                      device="cuda"):
    from ..geometry.sdf import make_sdf

    origin = -resolution * (dim - 1) / 2.0 * np.ones(3)
    ii, jj, kk = np.meshgrid(*(np.arange(dim),) * 3, indexing="ij")
    pts = origin + resolution * np.stack([ii, jj, kk], axis=-1)
    return make_sdf(fn(pts).astype(np.float32), origin, resolution,
                    device=device)


def _sphere_sdf(r):
    return lambda p: np.linalg.norm(p, axis=-1) - r


def _box_sdf(half):
    half = np.asarray(half)

    def fn(p):
        q = np.abs(p) - half
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inside = np.minimum(np.max(q, axis=-1), 0.0)
        return outside + inside

    return fn


def _cylinder_sdf(r, h):
    def fn(p):
        dxy = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - r
        dz = np.abs(p[..., 2]) - h / 2.0
        q = np.stack([dxy, dz], axis=-1)
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inside = np.minimum(np.max(q, axis=-1), 0.0)
        return outside + inside

    return fn


def _sample_sphere(rng, n, r):
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return r * v, v


def _sample_box(rng, n, half):
    hx, hy, hz = half
    areas = np.array([hy * hz, hx * hz, hx * hy])  # per face pair (x4 const)
    face_axis = rng.choice(3, n, p=areas / areas.sum())
    sign = rng.choice([-1.0, 1.0], n)
    u = rng.uniform(-1, 1, (n, 3)) * np.asarray(half)
    pts = u.copy()
    normals = np.zeros((n, 3))
    for a in range(3):
        m = face_axis == a
        pts[m, a] = sign[m] * half[a]
        normals[m, a] = sign[m]
    return pts, normals


def _sample_cylinder(rng, n, r, h):
    a_side = 2 * np.pi * r * h
    a_cap = np.pi * r * r
    which = rng.choice(2, n, p=np.array([a_side, 2 * a_cap])
                       / (a_side + 2 * a_cap))
    th = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 3))
    normals = np.zeros((n, 3))
    side = which == 0
    pts[side] = np.stack([r * np.cos(th[side]), r * np.sin(th[side]),
                          rng.uniform(-h / 2, h / 2, side.sum())], axis=1)
    normals[side] = np.stack([np.cos(th[side]), np.sin(th[side]),
                              np.zeros(side.sum())], axis=1)
    cap = ~side
    rr = r * np.sqrt(rng.uniform(0, 1, cap.sum()))
    sgn = rng.choice([-1.0, 1.0], cap.sum())
    pts[cap] = np.stack([rr * np.cos(th[cap]), rr * np.sin(th[cap]),
                         sgn * h / 2], axis=1)
    normals[cap, 2] = sgn
    return pts, normals


def _capsule_sdf(r, seg):
    """Capsule: segment of half-length ``seg`` along z, radius ``r``."""

    def fn(p):
        z = np.clip(p[..., 2], -seg, seg)
        q = p.copy()
        q[..., 2] = p[..., 2] - z
        return np.linalg.norm(q, axis=-1) - r

    return fn


def _sample_capsule(rng, n, r, seg):
    a_side = 2 * np.pi * r * (2 * seg)
    a_caps = 4 * np.pi * r * r
    cap = rng.rand(n) < a_caps / (a_side + a_caps)
    th = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 3))
    normals = np.zeros((n, 3))
    side = ~cap
    pts[side] = np.stack([r * np.cos(th[side]), r * np.sin(th[side]),
                          rng.uniform(-seg, seg, side.sum())], axis=1)
    normals[side] = np.stack([np.cos(th[side]), np.sin(th[side]),
                              np.zeros(side.sum())], axis=1)
    v = rng.randn(cap.sum(), 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    sgn = np.where(v[:, 2] >= 0, 1.0, -1.0)
    pts[cap] = r * v + np.stack([np.zeros(cap.sum()), np.zeros(cap.sum()),
                                 sgn * seg], axis=1)
    normals[cap] = v
    return pts, normals


# ---------------------------------------------------------------------------
# Mesh-backed objects: triangle mesh -> ops.mesh_to_sdf voxelizer (the
# SDFGen-replacement path, read_file_sdf.py:34-41), parametric samplers
# ---------------------------------------------------------------------------


def _uv_sphere(radii, nu=48, nv=24):
    """Watertight UV sphere scaled to ``radii`` (an ellipsoid mesh)."""
    rx, ry, rz = radii
    verts = [(0.0, 0.0, rz)]
    for i in range(1, nv):
        th = np.pi * i / nv
        for j in range(nu):
            ph = 2 * np.pi * j / nu
            verts.append((rx * np.sin(th) * np.cos(ph),
                          ry * np.sin(th) * np.sin(ph), rz * np.cos(th)))
    verts.append((0.0, 0.0, -rz))
    south = len(verts) - 1
    row = lambda i, j: 1 + (i - 1) * nu + (j % nu)
    tris = []
    for j in range(nu):  # north fan (outward CCW seen from outside)
        tris.append((0, row(1, j), row(1, j + 1)))
    for i in range(1, nv - 1):
        for j in range(nu):
            a, b = row(i, j), row(i, j + 1)
            c, d = row(i + 1, j), row(i + 1, j + 1)
            tris.append((a, c, b))
            tris.append((b, c, d))
    for j in range(nu):  # south fan
        tris.append((south, row(nv - 1, j + 1), row(nv - 1, j)))
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def _cone_mesh(r, h, nu=64):
    """Watertight cone: apex at +h/2, circular base at -h/2."""
    verts = [(0.0, 0.0, h / 2), (0.0, 0.0, -h / 2)]
    for j in range(nu):
        ph = 2 * np.pi * j / nu
        verts.append((r * np.cos(ph), r * np.sin(ph), -h / 2))
    ring = lambda j: 2 + (j % nu)
    tris = []
    for j in range(nu):
        tris.append((0, ring(j), ring(j + 1)))      # lateral
        tris.append((1, ring(j + 1), ring(j)))      # base
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def _torus_mesh(big_r, small_r, nu=48, nv=24):
    verts, tris = [], []
    for i in range(nu):
        u = 2 * np.pi * i / nu
        for j in range(nv):
            v = 2 * np.pi * j / nv
            w = big_r + small_r * np.cos(v)
            verts.append((w * np.cos(u), w * np.sin(u),
                          small_r * np.sin(v)))
    at = lambda i, j: (i % nu) * nv + (j % nv)
    for i in range(nu):
        for j in range(nv):
            a, b = at(i, j), at(i + 1, j)
            c, d = at(i, j + 1), at(i + 1, j + 1)
            tris.append((a, b, c))
            tris.append((b, d, c))
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def _sample_ellipsoid(rng, n, radii):
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * np.asarray(radii)
    normals = v / np.asarray(radii)  # grad of implicit surface
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return pts, normals


def _sample_cone(rng, n, r, h):
    slant = np.sqrt(r * r + h * h)
    a_side = np.pi * r * slant
    a_base = np.pi * r * r
    base = rng.rand(n) < a_base / (a_side + a_base)
    th = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 3))
    normals = np.zeros((n, 3))
    side = ~base
    # uniform over the lateral surface: radius fraction ~ sqrt(u)
    f = np.sqrt(rng.uniform(0, 1, side.sum()))
    pts[side] = np.stack([f * r * np.cos(th[side]), f * r * np.sin(th[side]),
                          h / 2 - f * h], axis=1)
    nz = r / slant
    nr = h / slant
    normals[side] = np.stack([nr * np.cos(th[side]), nr * np.sin(th[side]),
                              np.full(side.sum(), nz)], axis=1)
    rr = r * np.sqrt(rng.uniform(0, 1, base.sum()))
    pts[base] = np.stack([rr * np.cos(th[base]), rr * np.sin(th[base]),
                          np.full(base.sum(), -h / 2)], axis=1)
    normals[base, 2] = -1.0
    return pts, normals


def _sample_torus(rng, n, big_r, small_r):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    w = big_r + small_r * np.cos(v)
    pts = np.stack([w * np.cos(u), w * np.sin(u), small_r * np.sin(v)],
                   axis=1)
    normals = np.stack([np.cos(v) * np.cos(u), np.cos(v) * np.sin(u),
                        np.sin(v)], axis=1)
    return pts, normals


def _analytic_entry(fn, sampler):
    """(sdf_builder(dim, res, device) -> SdfGrid, sampler) for an analytic
    SDF."""
    return (lambda dim, res, device="cuda": _sdf_grid_from_fn(
        fn, 0.06, dim, res, device), sampler)


def _mesh_entry(mesh_builder, sampler):
    """Mesh-backed object: voxelized through ops.mesh_to_sdf (the SDFGen
    replacement, read_file_sdf.py:34-41; one K3 launch on the card), so
    that the parity experiment exercises the mesh pipeline and not analytic
    grids only."""

    def build(dim, res, device="cuda"):
        from ..geometry.mesh import Mesh3D
        from ..ops.mesh_to_sdf import mesh_to_sdf

        verts, tris = mesh_builder()
        return mesh_to_sdf(Mesh3D(verts, tris), dim=dim, padding=5,
                           device=device)

    return (build, sampler)


PARITY_OBJECTS = {
    # name -> (sdf_builder(dim, res, device) -> SdfGrid,
    #          surface_sampler(rng, n) -> (pts, normals))
    "parity_sphere": _analytic_entry(
        _sphere_sdf(0.032), lambda rng, n: _sample_sphere(rng, n, 0.032)),
    "parity_box": _analytic_entry(
        _box_sdf((0.024, 0.036, 0.020)),
        lambda rng, n: _sample_box(rng, n, (0.024, 0.036, 0.020))),
    "parity_cylinder": _analytic_entry(
        _cylinder_sdf(0.027, 0.09),
        lambda rng, n: _sample_cylinder(rng, n, 0.027, 0.09)),
    "parity_sphere_small": _analytic_entry(
        _sphere_sdf(0.024), lambda rng, n: _sample_sphere(rng, n, 0.024)),
    "parity_box_flat": _analytic_entry(
        _box_sdf((0.034, 0.025, 0.012)),
        lambda rng, n: _sample_box(rng, n, (0.034, 0.025, 0.012))),
    "parity_cylinder_thin": _analytic_entry(
        _cylinder_sdf(0.018, 0.075),
        lambda rng, n: _sample_cylinder(rng, n, 0.018, 0.075)),
    "parity_capsule": _analytic_entry(
        _capsule_sdf(0.020, 0.025),
        lambda rng, n: _sample_capsule(rng, n, 0.020, 0.025)),
    "parity_ellipsoid_mesh": _mesh_entry(
        lambda: _uv_sphere((0.036, 0.027, 0.021)),
        lambda rng, n: _sample_ellipsoid(rng, n, (0.036, 0.027, 0.021))),
    "parity_cone_mesh": _mesh_entry(
        lambda: _cone_mesh(0.032, 0.080),
        lambda rng, n: _sample_cone(rng, n, 0.032, 0.080)),
    "parity_torus_mesh": _mesh_entry(
        lambda: _torus_mesh(0.026, 0.012),
        lambda rng, n: _sample_torus(rng, n, 0.026, 0.012)),
}

# oblique viewpoints (a straight-overhead camera sees almost no side
# points; docs/QUIRKS.md GPG note) — one per view file
VIEW_CAMERAS = np.array([
    [0.5, 0.3, 0.4], [-0.4, 0.5, 0.35], [0.3, -0.5, 0.45],
    [-0.5, -0.3, 0.4], [0.55, 0.0, 0.3], [0.0, 0.55, 0.3],
], np.float32)


def build_parity_dataset(root: str, *, grasps_per_class: int = 12,
                         max_rounds: int = 12, views_per_object: int = 6,
                         points_per_view: int = 12000,
                         train_frac: float = 0.8, seed: int = 0,
                         sdf_dim: int = 56, sdf_res: float = 0.0022,
                         objects=None, noise_std: float = 3e-4,
                         device="cuda", draws_for_object=None):
    """Generate the parity dataset in the reference's on-disk layout.

    Per object: build its SDF on ``device``, label grasps with the labeling
    path (full 7-level friction ladder, FC_LIST_FULL — the multi-class ladder
    generate-dataset-canny.py uses when less_class is off, :88-95), shuffle,
    split train/test, and trim so every object contributes the SAME row
    count per split (the reference indexes (object, grasp) via
    np.unravel_index over one shared grasp_amount_per_file, dataset.py:508).
    Views are dense analytic surface samples, camera-visible filtered, with
    sub-voxel Gaussian noise. ``draws_for_object(i)``: the labeling draws of
    object i (default ``Draws(seed + 17 * i)`` on the SDF's device).

    Returns {"objects", "n_train", "n_test", "points_per_view"}.
    """
    from ..draws import Draws
    from ..grasping.evaluation import FC_LIST_FULL
    from ..grasping.gripper import Gripper
    from .generate_dataset import label_grasps_for_object

    objects = list(objects or PARITY_OBJECTS)
    gripper = Gripper()
    rng = np.random.RandomState(seed)
    dev = torch.device(device)

    grasp_dir_train = os.path.join(root, "PointNetGPD/data/ycb_grasp/train")
    grasp_dir_test = os.path.join(root, "PointNetGPD/data/ycb_grasp/test")
    os.makedirs(grasp_dir_train, exist_ok=True)
    os.makedirs(grasp_dir_test, exist_ok=True)

    rows_by_obj = {}
    for i, name in enumerate(objects):
        build_sdf, _ = PARITY_OBJECTS[name]
        sdf = build_sdf(sdf_dim, sdf_res, dev)
        draws = (Draws(seed + 17 * i, sdf.data.device)
                 if draws_for_object is None else draws_for_object(i))
        rows, counts, _ = label_grasps_for_object(
            sdf, np.zeros(3, np.float32), gripper, draws,
            fc_list=FC_LIST_FULL, grasps_per_class=grasps_per_class,
            max_rounds=max_rounds)
        if len(rows) < 10:
            raise RuntimeError(f"too few labeled grasps for {name}: "
                               f"{len(rows)} (counts={counts.tolist()})")
        rng.shuffle(rows)
        rows_by_obj[name] = rows

    n_min = min(len(r) for r in rows_by_obj.values())
    n_train = int(round(n_min * train_frac))
    n_test = n_min - n_train

    transform = {}
    for name in objects:
        rows = rows_by_obj[name]
        np.save(os.path.join(grasp_dir_train, f"{name}.npy"),
                rows[:n_train])
        np.save(os.path.join(grasp_dir_test, f"{name}.npy"),
                rows[n_train:n_train + n_test])
        transform[name] = (name, np.eye(4, dtype=np.float32))

        cloud_dir = os.path.join(
            root, f"data/ycb-tools/models/ycb/{name}/rgbd/clouds")
        os.makedirs(cloud_dir, exist_ok=True)
        _, sampler = PARITY_OBJECTS[name]
        for v in range(views_per_object):
            cam = VIEW_CAMERAS[v % len(VIEW_CAMERAS)]
            # oversample, visible-filter, then trim to a uniform view size
            pts, normals = sampler(rng, int(points_per_view * 2.6))
            vis = np.sum((cam - pts) * normals, axis=1) > 0
            pts = pts[vis]
            if len(pts) < points_per_view:
                extra = rng.choice(len(pts), points_per_view - len(pts))
                pts = np.concatenate([pts, pts[extra]])
            pts = pts[:points_per_view]
            pts = pts + rng.randn(*pts.shape) * noise_std
            np.save(os.path.join(cloud_dir, f"pc_NP3_NP5_{v}.npy"),
                    pts.astype(np.float32))

    with open(os.path.join(root, "PointNetGPD/data/google2cloud.pkl"),
              "wb") as f:
        pickle.dump(transform, f)
    return {"objects": objects, "n_train": n_train, "n_test": n_test,
            "points_per_view": points_per_view}


# ---------------------------------------------------------------------------
# Reference torch trainer (oracle; reference code imported, not copied;
# a copy of the JAX package's, which is torch already)
# ---------------------------------------------------------------------------


def _reference_root(reference_root=None) -> str:
    """The reference checkout: the argument, else $POINTNETGPD_REFERENCE,
    else ./reference."""
    return reference_root or os.environ.get("POINTNETGPD_REFERENCE",
                                            "reference")


def _load_reference_modules(root: str, reference_root: str | None = None):
    """Import the reference's dataset + model modules (from the checkout at
    ``reference_root``, see ``_reference_root``) against ``root``.

    open3d is not a dependency; only the GPD projection path touches it, so
    a stub module suffices (same trick as tests/test_crop_parity.py).
    """
    import importlib.util

    if "open3d" not in sys.modules:
        sys.modules["open3d"] = types.ModuleType("open3d")
    os.environ["PointNetGPD_FOLDER"] = root

    mods = {}
    for alias, rel in (("_parity_ref_dataset", "PointNetGPD/model/dataset.py"),
                       ("_parity_ref_pointnet", "PointNetGPD/model/pointnet.py")):
        path = os.path.join(_reference_root(reference_root), rel)
        spec = importlib.util.spec_from_file_location(alias, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods[alias.rsplit("_", 1)[-1]] = mod
    return mods["dataset"], mods["pointnet"]


def train_reference(root: str, *, epochs: int, batch_size: int = 64,
                    lr: float = 0.005, num_points: int = 750,
                    grasp_amount_train: int, grasp_amount_test: int,
                    thresh_good: float = 0.5, thresh_bad: float = 1.2,
                    num_classes: int = 3,
                    seed: int = 0, num_workers: int = 2,
                    reference_root: str | None = None):
    """Train the reference path on the parity dataset.

    Loop semantics are main_1v_mc.py's (which inherits main_1v.py:59-110):
    Adam(lr) RE-CREATED every epoch (the optimizer-reset quirk,
    main_1v.py:60-62 — docs/QUIRKS.md), F.nll_loss on the model's
    log_softmax, None-dropping collate, per-epoch eval in eval() mode.
    ``num_classes=2`` switches to main_1v.py semantics: the reference's
    PointGraspOneViewDataset (middle band dropped, dataset.py:448-452)
    and a k=2 head. Returns {"train_loss": [..], "test_acc": [..]}.
    """
    import torch.nn.functional as F

    dataset_mod, pointnet_mod = _load_reference_modules(root, reference_root)
    torch.manual_seed(seed)
    np.random.seed(seed)

    def my_collate(batch):  # main_1v.py:48-50
        batch = [b for b in batch if b is not None]
        return torch.utils.data.dataloader.default_collate(batch)

    ds_cls = (dataset_mod.PointGraspOneViewDataset if num_classes == 2
              else dataset_mod.PointGraspOneViewMultiClassDataset)

    def loader(tag, amount):
        ds = ds_cls(
            grasp_points_num=num_points, grasp_amount_per_file=amount,
            thresh_good=thresh_good, thresh_bad=thresh_bad, tag=tag)
        return torch.utils.data.DataLoader(
            ds, batch_size=batch_size, num_workers=num_workers,
            shuffle=True, collate_fn=my_collate, drop_last=False)

    train_loader = loader("train", grasp_amount_train)
    test_loader = loader("test", grasp_amount_test)

    model = pointnet_mod.PointNetCls(num_points=num_points, input_chann=3,
                                     k=num_classes)
    history = {"train_loss": [], "test_acc": []}
    for epoch in range(epochs):
        optimizer = torch.optim.Adam(model.parameters(), lr=lr)  # the quirk
        model.train()
        losses = []
        for data, target in train_loader:
            data, target = data.float(), target.long()
            optimizer.zero_grad()
            output, _ = model(data)
            loss = F.nll_loss(output, target)
            loss.backward()
            optimizer.step()
            losses.append(float(loss))
        model.eval()
        correct = total = 0
        with torch.no_grad():
            for data, target in test_loader:
                output, _ = model(data.float())
                correct += int((output.argmax(1) == target.long()).sum())
                total += len(target)
        history["train_loss"].append(float(np.mean(losses)))
        history["test_acc"].append(correct / max(total, 1))
    return history


# ---------------------------------------------------------------------------
# The port's trainer, same data / same semantics
# ---------------------------------------------------------------------------


def reset_optimizer(state, tx):
    """The reference's optimizer-reset quirk (main_1v.py:60-62: Adam(lr)
    re-created every epoch), as the JAX package's ``tx.init(params)``
    restarts optax's state: fresh Adam moments AND a fresh update count,
    which both Adam's bias correction and the StepLR schedule read
    (``AdamStepLR.factor``). So the optimizer and its scheduler are rebuilt
    together."""
    state.optimizer, state.scheduler = tx.init(state.model.parameters())
    return state


def train_ours(root: str, *, epochs: int, batch_size: int = 64,
               lr: float = 0.005, num_points: int = 750,
               cloud_points: int = 12000, thresh_good: float = 0.5,
               thresh_bad: float = 1.2, num_classes: int = 3, seed: int = 0,
               reset_optimizer_each_epoch: bool = True,
               steps_per_epoch: int | None = None,
               eval_batch: int = 64, device="cuda", draws=None, model=None):
    """Train the port's path (OneViewBatcher + fused crop train step) on
    the identical dataset files, with the same batch/lr/epochs and (by
    default) the same per-epoch optimizer reset as the reference loop.

    Eval is deterministic over the FULL test split: every (object, row)
    pair once per epoch, a random view per sample — the same estimator as
    the reference's test() pass; its trunks run kernel K2 on the card (2
    launches per eval batch). ``model``: the initial PointNetCls (default:
    initialized from a generator seeded ``seed``), moved to ``device``.
    ``draws``: the crops' source (module docstring; default
    ``Draws(seed + 2)`` on ``device``). Returns {"train_loss", "test_acc"}.
    """
    from ..draws import Draws
    from ..models.pointnet import PointNetCls
    from ..ops.crop import collect_grasp_clouds_batched
    from ..training.data import (
        GraspDataIndex, OneViewBatcher, labels_from_scores,
    )
    from ..training.train import (
        init_train_state, make_eval_step, make_fused_train_step,
        make_optimizer,
    )

    dev = torch.device(device)
    index = GraspDataIndex(root, tag="train")
    test_index = GraspDataIndex(root, tag="test")
    n_train = sum(
        len(np.load(index.grasp_files[o])) for o in index.objects)
    if steps_per_epoch is None:
        steps_per_epoch = max(1, int(round(n_train / batch_size)))

    batcher = OneViewBatcher(index, batch_size, cloud_points=cloud_points,
                             num_classes=num_classes, thresh_good=thresh_good,
                             thresh_bad=thresh_bad, seed=seed)

    tx = make_optimizer(lr, steps_per_epoch=steps_per_epoch)
    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = PointNetCls(input_chann=3, k=num_classes)
    state = init_train_state(model.to(dev), tx)
    train_step = make_fused_train_step(num_points=num_points,
                                       min_point_limit=50)
    eval_step = make_eval_step()
    if draws is None:
        draws = Draws(seed + 2, dev)

    def on_dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    # deterministic full-test-split eval set (object, row) pairs
    test_rows, test_clouds_files = [], []
    for o in test_index.objects:
        rows = np.load(test_index.grasp_files[o])
        files = test_index.cloud_files[test_index.transform[o][0]]
        for r in rows:
            test_rows.append(r)
            test_clouds_files.append(files)
    test_rows = np.asarray(test_rows, np.float32)
    t_labels, t_weights = labels_from_scores(
        test_rows[:, -2], test_rows[:, -1], thresh_good, thresh_bad,
        num_classes)

    rng = np.random.RandomState(seed + 1)  # eval view/subsample draws

    def evaluate(st, eval_draws):
        correct = total = 0.0
        n = len(test_rows)
        for s in range(0, n, eval_batch):
            e = min(s + eval_batch, n)
            b = e - s
            grasps = np.zeros((eval_batch, 12), np.float32)
            grasps[:b] = test_rows[s:e]
            clouds = np.zeros((eval_batch, cloud_points, 3), np.float32)
            for j in range(b):
                files = test_clouds_files[s + j]
                pc = np.load(files[rng.randint(len(files))])[:, :3]
                idx = rng.choice(len(pc), cloud_points,
                                 replace=len(pc) < cloud_points)
                clouds[j] = pc[idx]
            labels = np.zeros((eval_batch,), np.int64)
            labels[:b] = t_labels[s:e]
            weights = np.zeros((eval_batch,), np.float32)
            weights[:b] = t_weights[s:e]
            transforms = np.tile(np.eye(4, dtype=np.float32),
                                 (eval_batch, 1, 1))
            cropped, _, crop_valid = collect_grasp_clouds_batched(
                on_dev(grasps), on_dev(clouds), on_dev(transforms),
                eval_draws.next_round(), num_out=num_points,
                min_point_limit=50)
            w = on_dev(weights) * crop_valid.to(torch.float32)
            out = eval_step(st.model, cropped, on_dev(labels), w)
            correct += float(out["correct"])
            total += float(out["count"])
        return correct / max(total, 1.0)

    history = {"train_loss": [], "test_acc": []}
    try:
        for epoch in range(epochs):
            if reset_optimizer_each_epoch:
                state = reset_optimizer(state, tx)
            losses = []
            for _ in range(steps_per_epoch):
                grasps, clouds, transforms, labels, weights = next(batcher)
                state, metrics = train_step(
                    state, on_dev(grasps), on_dev(clouds), on_dev(transforms),
                    on_dev(labels, torch.int64), on_dev(weights),
                    draws.next_round())
                losses.append(float(metrics["loss"]))
            history["train_loss"].append(float(np.mean(losses)))
            history["test_acc"].append(evaluate(state, draws.next_round()))
    finally:
        batcher.close()
    return history
