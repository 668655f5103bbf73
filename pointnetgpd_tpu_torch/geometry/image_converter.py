"""Binary image -> extruded 3-D mesh.

Re-design of the reference converter (reference:
meshpy/meshpy/image_converter.py:22-255 ImageToMeshConverter: extrude a
binary object mask into a watertight solid): occupied pixels become a
top face + bottom face + boundary side walls at the given extrusion depth.

The port's own copy of ``pointnetgpd_tpu/geometry/image_converter.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh3D


def binary_image_to_mesh(binary_im: np.ndarray, extrusion: float = 1000.0,
                         scale_factor: float = 1.0) -> Mesh3D:
    """Extrude a binary image (nonzero == object) into a solid mesh.

    Pixel (i, j) spans [j, j+1] x [i, i+1] in x/y (image convention), the
    solid spans z in [-extrusion/2, extrusion/2]; everything scaled by
    ``scale_factor`` (image_converter.py:22-90 semantics).
    """
    occ = np.asarray(binary_im) != 0
    if not occ.any():
        raise ValueError("binary image has no occupied pixels")
    h, w = occ.shape
    z0, z1 = -extrusion / 2.0, extrusion / 2.0

    # vertex grid indices for corners of occupied pixels, two layers (bot/top)
    corner_used = np.zeros((h + 1, w + 1), bool)
    ii, jj = np.where(occ)
    for di in (0, 1):
        for dj in (0, 1):
            corner_used[ii + di, jj + dj] = True
    idx = -np.ones((h + 1, w + 1), np.int64)
    ci, cj = np.where(corner_used)
    idx[ci, cj] = np.arange(len(ci))
    n_layer = len(ci)

    verts = np.zeros((2 * n_layer, 3))
    verts[:n_layer] = np.stack([cj, ci, np.full(n_layer, z0)], axis=1)
    verts[n_layer:] = np.stack([cj, ci, np.full(n_layer, z1)], axis=1)

    tris = []
    for i, j in zip(ii, jj):
        a, b = idx[i, j], idx[i, j + 1]
        c, d = idx[i + 1, j + 1], idx[i + 1, j]
        # bottom face (z0), wound to face -z
        tris += [[a, c, b], [a, d, c]]
        # top face (z1), wound to face +z
        at, bt, ct, dt = a + n_layer, b + n_layer, c + n_layer, d + n_layer
        tris += [[at, bt, ct], [at, ct, dt]]

    # side walls on boundary edges (occupied pixel next to empty space)
    padded = np.zeros((h + 2, w + 2), bool)
    padded[1:-1, 1:-1] = occ
    for i, j in zip(ii, jj):
        pi, pj = i + 1, j + 1
        a, b = idx[i, j], idx[i, j + 1]
        c, d = idx[i + 1, j + 1], idx[i + 1, j]
        at, bt, ct, dt = a + n_layer, b + n_layer, c + n_layer, d + n_layer
        if not padded[pi - 1, pj]:   # top edge (image up): wall a-b
            tris += [[a, b, bt], [a, bt, at]]
        if not padded[pi + 1, pj]:   # bottom edge: wall d-c
            tris += [[c, d, dt], [c, dt, ct]]
        if not padded[pi, pj - 1]:   # left edge: wall a-d
            tris += [[d, a, at], [d, at, dt]]
        if not padded[pi, pj + 1]:   # right edge: wall b-c
            tris += [[b, c, ct], [b, ct, bt]]

    mesh = Mesh3D(verts * scale_factor, np.asarray(tris, np.int32))
    return mesh.center_vertices_bb()
