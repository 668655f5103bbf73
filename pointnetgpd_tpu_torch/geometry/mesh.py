"""Triangle-mesh geometry core (host-side numpy).

The port's own copy of ``pointnetgpd_tpu/geometry/mesh.py`` (numpy only, so
it is copied rather than imported; tests/test_torch_voxelizer.py holds the
two equal). Re-implementation of the reference Mesh3D capabilities (reference:
meshpy/meshpy/mesh.py) without the trimesh dependency: mass properties by
signed-tetrahedron integration (mesh.py:210-226,1224-1298), bounding
boxes/principal dims (:227-318), triangle centers/normals/areas (:340-440),
cleanup (:441-498), centering/normalization (:499-567), subdivision (:682),
transforms (:735), random surface sampling (:767), rescaling (:835-886),
convex hull (scipy/qhull instead of trimesh, :887), watertight check
(:1203-1215), and quasi-static stable poses via hull-face toppling
(:900-932,1500-1577 — same sink-drain idea; initial face probabilities are
the reference's quasi-static spherical-map solid angles, see
``_spherical_projection_areas``).

Host-side by design: mesh processing is offline preprocessing; the device
path consumes its outputs (SDFs, surface samples, stable-pose transforms).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh3D:
    vertices: np.ndarray   # (V, 3) float64
    triangles: np.ndarray  # (F, 3) int32
    density: float = 1.0

    # ------------------------------------------------------------------
    # Basic per-triangle quantities (mesh.py:340-440)
    # ------------------------------------------------------------------
    def tri_vertices(self):
        return self.vertices[self.triangles]  # (F, 3, 3)

    def tri_centers(self):
        return self.tri_vertices().mean(axis=1)

    def tri_normals(self, normalized: bool = True):
        tv = self.tri_vertices()
        n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        if normalized:
            n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-16)
        return n

    def tri_areas(self):
        tv = self.tri_vertices()
        return 0.5 * np.linalg.norm(
            np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=1)

    def surface_area(self) -> float:
        return float(self.tri_areas().sum())

    # ------------------------------------------------------------------
    # Mass properties by divergence theorem (mesh.py:1224-1298)
    # ------------------------------------------------------------------
    def volume(self) -> float:
        tv = self.tri_vertices()
        return float(np.abs(np.sum(np.einsum(
            "fi,fi->f", tv[:, 0], np.cross(tv[:, 1], tv[:, 2]))) / 6.0))

    def signed_volume(self) -> float:
        tv = self.tri_vertices()
        return float(np.sum(np.einsum(
            "fi,fi->f", tv[:, 0], np.cross(tv[:, 1], tv[:, 2]))) / 6.0)

    def center_of_mass(self) -> np.ndarray:
        tv = self.tri_vertices()
        svols = np.einsum("fi,fi->f", tv[:, 0], np.cross(tv[:, 1], tv[:, 2])) / 6.0
        centroids = tv.sum(axis=1) / 4.0  # tetra centroid: (v0+v1+v2+origin)/4
        total = svols.sum()
        if abs(total) < 1e-16:
            return self.vertices.mean(axis=0)
        return (centroids * svols[:, None]).sum(axis=0) / total

    def mass(self) -> float:
        return self.density * self.volume()

    def inertia(self, reference_point=None) -> np.ndarray:
        """Inertia tensor about a reference point (default: COM), solid body
        with uniform density (mesh.py:1300-1380's covariance route)."""
        if reference_point is None:
            reference_point = self.center_of_mass()
        tv = self.tri_vertices() - reference_point
        # canonical-tetrahedron covariance integration
        c_canonical = np.array([[1 / 60, 1 / 120, 1 / 120],
                                [1 / 120, 1 / 60, 1 / 120],
                                [1 / 120, 1 / 120, 1 / 60]])
        cov = np.zeros((3, 3))
        total_vol = 0.0
        for f in range(tv.shape[0]):
            a = tv[f].T  # columns are vertices
            detj = np.linalg.det(a)
            cov += detj * a @ c_canonical @ a.T
            total_vol += detj / 6.0
        if abs(total_vol) < 1e-16:
            return np.zeros((3, 3))
        cov *= self.density
        trace = np.trace(cov)
        return trace * np.eye(3) - cov

    def covariance(self) -> np.ndarray:
        """Surface covariance (mesh.py:415-440): area-weighted second moment
        of triangle centroids about the mean."""
        centers = self.tri_centers()
        areas = self.tri_areas()
        w = areas / max(areas.sum(), 1e-16)
        mean = (centers * w[:, None]).sum(axis=0)
        d = centers - mean
        return (w[:, None, None] * np.einsum("fi,fj->fij", d, d)).sum(axis=0)

    # ------------------------------------------------------------------
    # Bounding geometry (mesh.py:227-318)
    # ------------------------------------------------------------------
    def bounding_box(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def bounding_box_center(self):
        lo, hi = self.bounding_box()
        return 0.5 * (lo + hi)

    def principal_dims(self):
        lo, hi = self.bounding_box()
        return hi - lo

    def max_dim(self) -> float:
        return float(self.principal_dims().max())

    def min_dim(self) -> float:
        return float(self.principal_dims().min())

    def median_dim(self) -> float:
        return float(np.median(self.principal_dims()))

    def diag_dim(self) -> float:
        return float(np.linalg.norm(self.principal_dims()))

    # ------------------------------------------------------------------
    # Cleanup / edits (mesh.py:441-567, 682, 735, 835-886)
    # ------------------------------------------------------------------
    def remove_bad_tris(self) -> "Mesh3D":
        t = self.triangles
        v = len(self.vertices)
        ok = ((t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])
              & (t >= 0).all(axis=1) & (t < v).all(axis=1))
        return Mesh3D(self.vertices.copy(), t[ok].copy(), self.density)

    def remove_unreferenced_vertices(self) -> "Mesh3D":
        used = np.unique(self.triangles)
        remap = -np.ones(len(self.vertices), dtype=np.int64)
        remap[used] = np.arange(len(used))
        return Mesh3D(self.vertices[used].copy(),
                      remap[self.triangles].astype(np.int32), self.density)

    def center_vertices_bb(self) -> "Mesh3D":
        return Mesh3D(self.vertices - self.bounding_box_center(),
                      self.triangles.copy(), self.density)

    def center_vertices_avg(self) -> "Mesh3D":
        return Mesh3D(self.vertices - self.vertices.mean(axis=0),
                      self.triangles.copy(), self.density)

    def normalize_vertices(self) -> "Mesh3D":
        """Center at COM and align principal axes (largest surface-covariance
        eigenvector -> x) (mesh.py:520-567)."""
        com = self.center_of_mass()
        verts = self.vertices - com
        cov = Mesh3D(verts, self.triangles).covariance()
        evals, evecs = np.linalg.eigh(cov)
        order = np.argsort(evals)[::-1]
        rot = evecs[:, order]
        if np.linalg.det(rot) < 0:
            rot[:, 2] = -rot[:, 2]
        return Mesh3D(verts @ rot, self.triangles.copy(), self.density)

    def transform(self, t_4x4: np.ndarray) -> "Mesh3D":
        v = self.vertices @ t_4x4[:3, :3].T + t_4x4[:3, 3]
        return Mesh3D(v, self.triangles.copy(), self.density)

    def rescale(self, scale: float) -> "Mesh3D":
        return Mesh3D(self.vertices * scale, self.triangles.copy(), self.density)

    def rescale_dimension(self, target: float, mode: str = "max") -> "Mesh3D":
        """RescalingType min/med/max/diag/relative (mesh_processor.py:40-48)."""
        current = {"min": self.min_dim(), "med": self.median_dim(),
                   "max": self.max_dim(), "diag": self.diag_dim(),
                   "relative": 1.0}[mode]
        return self.rescale(target / current)

    def subdivide(self) -> "Mesh3D":
        """Midpoint 1->4 subdivision (mesh.py:682-733)."""
        tv = self.tri_vertices()
        mids = 0.5 * (tv[:, [0, 1, 2]] + tv[:, [1, 2, 0]])  # (F, 3, 3)
        verts = [self.vertices]
        base = len(self.vertices)
        mid_idx = base + np.arange(3 * len(self.triangles)).reshape(-1, 3)
        verts.append(mids.reshape(-1, 3))
        t = self.triangles
        m01, m12, m20 = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
        new_tris = np.concatenate([
            np.stack([t[:, 0], m01, m20], axis=1),
            np.stack([m01, t[:, 1], m12], axis=1),
            np.stack([m20, m12, t[:, 2]], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ]).astype(np.int32)
        out = Mesh3D(np.concatenate(verts), new_tris, self.density)
        return out.merge_duplicate_vertices()

    def decimate(self, target_tris: int) -> "Mesh3D":
        """Vertex-clustering decimation: quantize vertices to a uniform grid
        sized so the result lands near ``target_tris`` triangles. Used to cut
        the YCB google_512k meshes (~500k tris) to voxelizer-friendly sizes
        before ops/mesh_to_sdf (the external SDFGen handled huge meshes by
        streaming; the batched voxelizer prefers fewer triangles)."""
        if len(self.triangles) <= target_tris:
            return self
        lo, hi = self.bounding_box()
        span = float((hi - lo).max())
        # triangles scale ~ quadratically with grid resolution
        n_cells = max(int(np.sqrt(target_tris / 2.0)), 3)
        for _ in range(8):
            cell = span / n_cells
            q = np.floor((self.vertices - lo) / max(cell, 1e-12)).astype(np.int64)
            _, first, inverse = np.unique(q, axis=0, return_index=True,
                                          return_inverse=True)
            # representative vertex = centroid of the cluster
            reps = np.zeros((len(first), 3))
            counts = np.zeros(len(first))
            np.add.at(reps, inverse, self.vertices)
            np.add.at(counts, inverse, 1.0)
            reps /= counts[:, None]
            tris = inverse[self.triangles]
            ok = ((tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
                  & (tris[:, 0] != tris[:, 2]))
            tris = tris[ok]
            # dedupe identical triangles up to cyclic rotation (orientation
            # preserved): rotate each so the smallest index leads
            shift = np.argmin(tris, axis=1)
            rolled = np.stack([
                tris[np.arange(len(tris)), shift],
                tris[np.arange(len(tris)), (shift + 1) % 3],
                tris[np.arange(len(tris)), (shift + 2) % 3],
            ], axis=1)
            tris = np.unique(rolled, axis=0)
            out = Mesh3D(reps, tris.astype(np.int32), self.density)
            if len(out.triangles) <= target_tris or n_cells <= 3:
                return out.remove_unreferenced_vertices()
            n_cells = max(int(n_cells * 0.8), 3)
        return out.remove_unreferenced_vertices()

    def merge_duplicate_vertices(self, tol: float = 1e-12) -> "Mesh3D":
        rounded = np.round(self.vertices / max(tol, 1e-12)).astype(np.int64)
        _, first, inverse = np.unique(rounded, axis=0, return_index=True,
                                      return_inverse=True)
        return Mesh3D(self.vertices[first],
                      inverse[self.triangles].astype(np.int32), self.density)

    # ------------------------------------------------------------------
    # Sampling / queries (mesh.py:767-834)
    # ------------------------------------------------------------------
    def random_surface_points(self, n: int, rng=None):
        rng = rng or np.random.RandomState()
        areas = self.tri_areas()
        probs = areas / areas.sum()
        tri_idx = rng.choice(len(areas), size=n, p=probs)
        tv = self.tri_vertices()[tri_idx]
        r1 = np.sqrt(rng.rand(n, 1))
        r2 = rng.rand(n, 1)
        pts = (1 - r1) * tv[:, 0] + r1 * (1 - r2) * tv[:, 1] + r1 * r2 * tv[:, 2]
        return pts, tri_idx

    def vertex_normals(self) -> np.ndarray:
        """Area-weighted per-vertex normals (mesh.py:568-600)."""
        tn = self.tri_normals(normalized=False)  # area-weighted
        vn = np.zeros_like(self.vertices)
        for k in range(3):
            np.add.at(vn, self.triangles[:, k], tn)
        norms = np.linalg.norm(vn, axis=1, keepdims=True)
        return vn / np.maximum(norms, 1e-16)

    def ray_intersections(self, origin, direction) -> np.ndarray:
        """All ray/triangle intersection points, sorted by distance
        (mesh.py:788-834). Batched Moller-Trumbore over all triangles."""
        origin = np.asarray(origin, float)
        d = np.asarray(direction, float)
        d = d / max(np.linalg.norm(d), 1e-16)
        tv = self.tri_vertices()
        e1 = tv[:, 1] - tv[:, 0]
        e2 = tv[:, 2] - tv[:, 0]
        p = np.cross(d, e2)
        det = np.einsum("fi,fi->f", e1, p)
        ok = np.abs(det) > 1e-12
        inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        s = origin - tv[:, 0]
        u = np.einsum("fi,fi->f", s, p) * inv_det
        q = np.cross(s, e1)
        v = np.einsum("i,fi->f", d, q) * inv_det
        t = np.einsum("fi,fi->f", e2, q) * inv_det
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-12)
        ts = np.sort(t[hit])
        # dedupe hits on shared edges/vertices (both adjacent triangles match)
        if len(ts):
            keep = np.concatenate([[True], np.diff(ts) > 1e-9])
            ts = ts[keep]
        return origin[None, :] + ts[:, None] * d[None, :]

    def merge(self, other: "Mesh3D") -> "Mesh3D":
        """Concatenate two meshes (mesh.py:1066-1100)."""
        verts = np.concatenate([self.vertices, other.vertices])
        tris = np.concatenate([
            self.triangles,
            np.asarray(other.triangles) + len(self.vertices),
        ]).astype(np.int32)
        return Mesh3D(verts, tris, self.density)

    def resting_pose(self, t_obj_world: np.ndarray):
        """The stable pose the object settles into from a given initial pose
        (mesh.py:933-1000): the stable pose whose face normal is most
        anti-aligned with the initial world-frame down direction."""
        poses = self.stable_poses()
        if not poses:
            return None
        rot = np.asarray(t_obj_world)[:3, :3]
        down_obj = rot.T @ np.array([0.0, 0.0, -1.0])
        best = max(poses,
                   key=lambda pose: float(-pose["r"][2] @ down_obj))
        return best

    def is_watertight(self) -> bool:
        """Every edge shared by exactly two triangles (mesh.py:1203-1215)."""
        t = self.triangles
        edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        edges = np.sort(edges, axis=1)
        _, counts = np.unique(edges, axis=0, return_counts=True)
        return bool((counts == 2).all())

    def convex_hull(self) -> "Mesh3D":
        from scipy.spatial import ConvexHull

        hull = ConvexHull(self.vertices)
        # orient each simplex outward (qhull winding is inconsistent)
        tris = hull.simplices.copy()
        tv = self.vertices[tris]
        n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        flip = np.einsum("fi,fi->f", n, hull.equations[:, :3]) < 0
        tris[flip] = tris[flip][:, [0, 2, 1]]
        # reindex to hull vertices
        remap = -np.ones(len(self.vertices), dtype=np.int64)
        remap[hull.vertices] = np.arange(len(hull.vertices))
        return Mesh3D(self.vertices[hull.vertices],
                      remap[tris].astype(np.int32), self.density)

    # ------------------------------------------------------------------
    # Stable poses (mesh.py:900-932, 1500-1577)
    # ------------------------------------------------------------------
    def stable_poses(self, min_prob: float = 0.0):
        """Quasi-static stable poses by toppling on the convex hull.

        Each hull face either supports the COM (its projection falls inside
        the face -> stable sink) or topples across its closest edge onto the
        neighboring face; face probability mass drains to sinks. Initial
        probabilities are the quasi-static spherical map: each hull triangle
        is projected from the COM onto the unit sphere and its spherical
        area (L'Huilier's theorem) over 4*pi is the chance a random tumble
        lands on it (reference: meshpy/mesh.py:1418-1452 _compute_proj_area,
        used at :1540). The areas tile the sphere, so the prior sums to 1.

        Returns a list of dicts {p, r, x0, face}: probability, 3x3 rotation
        taking object coords to a frame with the face down (z up), a support
        point, and the face's vertex indices — the StablePose fields
        (meshpy/stable_pose.py:12-85).
        """
        from scipy.spatial import ConvexHull

        if len(self.vertices) < 4 or abs(self.volume()) < 1e-12:
            raise ValueError(
                "stable_poses requires a non-degenerate solid mesh "
                f"({len(self.vertices)} vertices, volume {self.volume():.3g})")
        com = self.center_of_mass()
        hull = ConvexHull(self.vertices)
        tris = hull.simplices                # (T, 3) into self.vertices
        eqs = hull.equations                 # (T, 4) outward normals + offset

        # merge coplanar triangles into faces (a cube face is 2 qhull
        # simplices; toppling must treat it as one support polygon)
        keys = np.round(eqs / np.maximum(np.linalg.norm(eqs[:, :3], axis=1,
                                                        keepdims=True), 1e-18), 6)
        _, group = np.unique(keys, axis=0, return_inverse=True)
        n_faces = group.max() + 1
        face_tris = [np.where(group == g)[0] for g in range(n_faces)]

        tri_sph = _spherical_projection_areas(self.vertices, tris, com)
        probs0 = np.array([tri_sph[ts].sum() for ts in face_tris]) / (4 * np.pi)
        normals = np.stack([eqs[ts[0], :3] for ts in face_tris])
        normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                              1e-18)
        faces = [np.unique(tris[ts]) for ts in face_tris]  # vertex ids / face

        # boundary edges of each merged face (edges used once within it),
        # and edge -> faces adjacency over boundary edges
        face_edges: list = []
        edge_faces: dict = {}
        for g, ts in enumerate(face_tris):
            count: dict = {}
            for ti in ts:
                tri = tris[ti]
                for a, b in ((0, 1), (1, 2), (2, 0)):
                    e = tuple(sorted((tri[a], tri[b])))
                    count[e] = count.get(e, 0) + 1
            boundary = [e for e, c in count.items() if c == 1]
            face_edges.append(boundary)
            for e in boundary:
                edge_faces.setdefault(e, []).append(g)

        def _inside_tri(proj, tv):
            v0, v1 = tv[1] - tv[0], tv[2] - tv[0]
            w = proj - tv[0]
            d00, d01, d11 = v0 @ v0, v0 @ v1, v1 @ v1
            dw0, dw1 = w @ v0, w @ v1
            denom = d00 * d11 - d01 * d01
            if abs(denom) < 1e-18:
                return False
            u = (d11 * dw0 - d01 * dw1) / denom
            v = (d00 * dw1 - d01 * dw0) / denom
            return u >= -1e-12 and v >= -1e-12 and u + v <= 1 + 1e-12

        def _topple(fi):
            n = normals[fi]
            ref_pt = self.vertices[faces[fi][0]]
            proj = com - np.dot(com - ref_pt, n) * n
            if any(_inside_tri(proj, self.vertices[tris[ti]])
                   for ti in face_tris[fi]):
                return fi  # stable sink
            # topple across the closest boundary edge to the projection
            best_e, best_d = None, np.inf
            for e in face_edges[fi]:
                pa, pb = self.vertices[e[0]], self.vertices[e[1]]
                t = np.clip(((proj - pa) @ (pb - pa))
                            / max((pb - pa) @ (pb - pa), 1e-18), 0, 1)
                dist = np.linalg.norm(proj - (pa + t * (pb - pa)))
                if dist < best_d:
                    best_d = dist
                    best_e = e
            cand = [f for f in edge_faces.get(best_e, []) if f != fi]
            return cand[0] if cand else fi

        # each face's target once: the drain below revisits the faces of
        # every path (a 60,000-triangle torus asks 7x as often as it has
        # hull faces)
        targets: dict = {}

        def topple_target(fi):
            if fi not in targets:
                targets[fi] = _topple(fi)
            return targets[fi]

        # drain probability mass to sinks
        n_faces = len(faces)
        sink = np.arange(n_faces)
        for fi in range(n_faces):
            cur, seen = fi, set()
            while True:
                nxt = topple_target(cur)
                if nxt == cur or nxt in seen:
                    break
                seen.add(cur)
                cur = nxt
            sink[fi] = cur

        poses = []
        for s in np.unique(sink):
            if topple_target(s) != s:
                continue  # cycles without a true sink: skip
            p = probs0[sink == s].sum()
            if p < min_prob:
                continue
            n = normals[s]
            # rotation: face normal -> -z (face down on the table)
            z = -n / np.linalg.norm(n)
            x = np.cross([0.0, 1.0, 0.0], z)
            if np.linalg.norm(x) < 1e-8:
                x = np.cross([1.0, 0.0, 0.0], z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            r = np.stack([x, y, z])  # rows: world axes in object coords
            x0 = self.vertices[faces[s][0]]
            poses.append({"p": float(p), "r": r, "x0": x0,
                          "face": faces[s].copy()})
        poses.sort(key=lambda d: -d["p"])
        return poses


def _spherical_projection_areas(verts, tris, cm) -> np.ndarray:
    """(T,) spherical area of each triangle projected from ``cm`` onto the
    unit sphere, via L'Huilier's theorem (reference: meshpy/mesh.py:1418-1452
    — there per-triangle with math.acos/atan; here vectorized; the
    reference's exception fallback ``s += 0.001`` for slightly-negative
    tangent products is replaced by clipping the product to >= 0, identical
    on non-degenerate triangles)."""
    pv = verts[np.asarray(tris)] - np.asarray(cm)          # (T, 3, 3)
    pv = pv / np.maximum(np.linalg.norm(pv, axis=-1, keepdims=True), 1e-300)

    def _angle(u, v):
        return np.arccos(np.clip(np.einsum("ti,ti->t", u, v), -1.0, 1.0))

    a = _angle(pv[:, 0], pv[:, 1])
    b = _angle(pv[:, 0], pv[:, 2])
    c = _angle(pv[:, 1], pv[:, 2])
    s = (a + b + c) / 2
    prod = (np.tan(s / 2) * np.tan((s - a) / 2) * np.tan((s - b) / 2)
            * np.tan((s - c) / 2))
    return 4 * np.arctan(np.sqrt(np.maximum(prod, 0.0)))


def center_of_mass(vertices, triangles) -> np.ndarray:
    """Convenience: COM of a (V,3)/(F,3) mesh."""
    return Mesh3D(np.asarray(vertices), np.asarray(triangles)).center_of_mass()
