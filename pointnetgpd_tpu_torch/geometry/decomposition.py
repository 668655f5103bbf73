"""Approximate convex decomposition (vhacd replacement).

Port of ``pointnetgpd_tpu/geometry/decomposition.py``. The reference
delegates multi-piece decomposition to trimesh's vhacd binding (reference:
meshpy/meshpy/urdf_writer.py:76 ``convex_decomposition``); vhacd is a
voxel-based splitter: voxelize the solid, greedily split the most concave
voxel cluster with a plane, emit the convex hull of each final cluster. The
voxelization is one :func:`pointnetgpd_tpu_torch.ops.mesh_to_sdf.mesh_to_sdf`
call (kernel K3 on CUDA); the greedy plane search and the hulls run on the
host with numpy and scipy.

Precondition inherited from the voxelizer: the input mesh must not be
self-intersecting (ray parity is undefined on overlapping-solid unions).

Control flow mirrors vhacd's: split greedily until every cluster is within
the concavity tolerance, then MERGE adjacent clusters back together whenever
their union stays within tolerance (vhacd's refinement pass; the greedy
splitter over-cuts, and the merge repairs the piece count). Candidate split
planes cover the 3 axes plus the 6 in-plane 45-degree diagonals (vhacd
searches a continuous normal space; the quartile x 9-direction grid is the
discrete analogue).
"""

from __future__ import annotations

import heapq
import numpy as np

from .mesh import Mesh3D

# the 8 cube-corner offsets of a voxel, in cell units
_CORNERS = np.array([[i, j, k] for i in (-0.5, 0.5)
                     for j in (-0.5, 0.5) for k in (-0.5, 0.5)])


def _hull_mesh(points: np.ndarray) -> Mesh3D:
    from scipy.spatial import ConvexHull

    hull = ConvexHull(points)
    # orient each simplex outward using qhull's facet equations
    tris = []
    for simplex, eq in zip(hull.simplices, hull.equations):
        a, b, c = points[simplex]
        n = np.cross(b - a, c - a)
        tris.append(simplex if np.dot(n, eq[:3]) > 0 else simplex[::-1])
    return Mesh3D(points[hull.vertices],
                  _reindex(np.asarray(tris), hull.vertices))


def _reindex(tris: np.ndarray, used: np.ndarray) -> np.ndarray:
    remap = np.full(int(tris.max()) + 1, -1, np.int64)
    remap[used] = np.arange(len(used))
    return remap[tris]


def _hull_volume(points: np.ndarray) -> float:
    from scipy.spatial import ConvexHull

    try:
        return float(ConvexHull(points).volume)
    except Exception:  # degenerate (planar/collinear) clusters
        return 0.0


class _Cluster:
    """A set of occupied voxel centers (integer grid coords)."""

    def __init__(self, cells: np.ndarray, res: float):
        self.cells = cells
        self.res = res
        self.vox_volume = len(cells) * res ** 3
        # hull over the voxel CORNER lattice so the hull covers the full
        # occupied cells, not just their centers
        self.corner_pts = self._corner_points()
        self.hull_volume = _hull_volume(self.corner_pts)
        # vhacd's concavity proxy: how much of the hull is empty space
        if self.hull_volume <= 0:
            self.concavity = 0.0
        else:
            self.concavity = max(0.0, 1.0 - self.vox_volume / self.hull_volume)

    def _corner_points(self) -> np.ndarray:
        # the corners are half-integers: one int64 key per corner, unique'd
        # in 1-D, gives exactly np.unique(corners, axis=0) (rows in
        # lexicographic order) at a fraction of its sort's cost
        c = (self.cells[:, None, :] + _CORNERS[None] + 0.5).reshape(-1, 3)
        c = c.astype(np.int64)
        m = int(c.max()) + 1
        key = np.unique((c[:, 0] * m + c[:, 1]) * m + c[:, 2])
        rows = np.stack([key // (m * m), key // m % m, key % m], axis=1)
        return (rows - 0.5) * self.res

    # candidate split-plane normals: the 3 axes plus the 6 in-plane
    # diagonals (vhacd searches a continuous normal space; this 9-direction
    # grid covers its axis + 45-degree candidates)
    _SPLIT_DIRS = np.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1],
         [1, 1, 0], [1, -1, 0], [1, 0, 1],
         [1, 0, -1], [0, 1, 1], [0, 1, -1]], np.float64)

    def split(self):
        """Best planar split: quartile planes of the occupied cells along
        each candidate direction; keep the split minimizing total child
        hull volume (vhacd's 'minimum concavity' plane selection over a
        discrete normal grid)."""
        best = None
        for d in self._SPLIT_DIRS:
            coords = self.cells @ d
            lo, hi = coords.min(), coords.max()
            if hi - lo < 1:
                continue
            for q in (0.25, 0.5, 0.75):
                cut = lo + q * (hi - lo)
                left = self.cells[coords <= cut]
                right = self.cells[coords > cut]
                if len(left) == 0 or len(right) == 0:
                    continue
                a = _Cluster(left, self.res)
                b = _Cluster(right, self.res)
                cost = a.hull_volume + b.hull_volume
                if best is None or cost < best[0]:
                    best = (cost, a, b)
        return (best[1], best[2]) if best is not None else None


_FACE_NEIGHBORS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                            [0, -1, 0], [0, 0, 1], [0, 0, -1], [0, 0, 0]])


def _clusters_adjacent(a: "_Cluster", b: "_Cluster") -> bool:
    """True when some voxel of ``a`` face-touches (or overlaps) one of ``b``."""
    small, big = (a, b) if len(a.cells) <= len(b.cells) else (b, a)
    big_set = {tuple(c) for c in big.cells.astype(np.int64)}
    for c in small.cells.astype(np.int64):
        for d in _FACE_NEIGHBORS:
            if tuple(c + d) in big_set:
                return True
    return False


def _merge_pass(clusters: list, concavity_tol: float, res: float) -> list:
    """vhacd's cluster-merge refinement: repeatedly merge the adjacent pair
    whose UNION has the lowest concavity, as long as that concavity stays
    within tolerance. Repairs the over-cutting of the greedy splitter
    (e.g. an L cut into 3 collapses back to 2)."""
    clusters = list(clusters)
    while len(clusters) > 1:
        best = None
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                if not _clusters_adjacent(clusters[i], clusters[j]):
                    continue
                union = _Cluster(
                    np.concatenate([clusters[i].cells, clusters[j].cells]),
                    res)
                if union.concavity <= concavity_tol and (
                        best is None or union.concavity < best[0]):
                    best = (union.concavity, i, j, union)
        if best is None:
            break
        _, i, j, union = best
        clusters = [c for k, c in enumerate(clusters)
                    if k not in (i, j)] + [union]
    return clusters


def approximate_convex_decomposition(
        mesh: Mesh3D, max_pieces: int = 8, concavity_tol: float = 0.05,
        dim: int = 48, min_cells: int = 8, device="cuda"):
    """Voxel-based approximate convex decomposition.

    Mirrors vhacd's control flow (reference consumer:
    meshpy/meshpy/urdf_writer.py:76): voxelize, greedily split the cluster
    with the highest concavity ``1 - vox_volume / hull_volume`` until every
    cluster is within ``concavity_tol`` or ``max_pieces`` is reached, then
    run the merge refinement (adjacent clusters whose union stays within
    tolerance collapse back into one piece). Returns a list of convex
    :class:`Mesh3D` pieces (length 1 for convex inputs).
    """
    from ..ops.mesh_to_sdf import mesh_to_sdf

    sdf = mesh_to_sdf(mesh, dim=dim, padding=2, device=device)
    inside = sdf.data.cpu().numpy() < 0
    cells = np.argwhere(inside).astype(np.float64)
    if len(cells) < min_cells:
        return [mesh.convex_hull()]
    res = float(sdf.resolution)
    origin = sdf.origin.cpu().numpy().astype(np.float64)

    root = _Cluster(cells, res)
    # max-heap on concavity; counter breaks ties deterministically
    heap = [(-root.concavity, 0, root)]
    done = []
    counter = 1
    while heap and len(heap) + len(done) < max_pieces:
        neg_c, _, cl = heapq.heappop(heap)
        if -neg_c <= concavity_tol or len(cl.cells) < min_cells:
            done.append(cl)
            continue
        split = cl.split()
        if split is None:
            done.append(cl)
            continue
        for child in split:
            heapq.heappush(heap, (-child.concavity, counter, child))
            counter += 1
    done.extend(cl for _, _, cl in heap)
    done = _merge_pass(done, concavity_tol, res)

    pieces = []
    for cl in done:
        if cl.hull_volume <= 0:
            continue
        pieces.append(_hull_mesh(cl.corner_pts + origin))
    return pieces if pieces else [mesh.convex_hull()]
