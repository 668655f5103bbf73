"""Host-side geometry file IO: .sdf / .obj / .off readers and writers.

Port of ``pointnetgpd_tpu/geometry/io.py``; files written by either package
are byte-identical and read back by the other. Formats mirrored from the
reference:
- .sdf text grid: dims line, origin line, resolution line, then one value per
  line with x fastest and z slowest (reference: meshpy/meshpy/sdf_file.py:67-95).
- .obj: v/f lines with 1-based (optionally slash-qualified) indices
  (reference: meshpy/meshpy/obj_file.py:51-160).
- .off: header, counts line, vertices, faces (reference: meshpy/meshpy/off_file.py:37-91).
"""

from __future__ import annotations

import numpy as np

from .sdf import SdfGrid, make_sdf


def read_sdf(path: str, device="cuda") -> SdfGrid:
    """Parse the reference .sdf text format into an SdfGrid on ``device``."""
    with open(path, "r") as f:
        dims = np.array([int(i) for i in f.readline().split()])
        origin = np.array([float(i) for i in f.readline().split()])
        resolution = float(f.readline())
        values = np.fromstring(f.read(), dtype=np.float32, sep="\n")
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    if values.size != nx * ny * nz:
        raise ValueError(
            f"{path}: expected {nx * ny * nz} sdf values, got {values.size}"
        )
    # file order: x fastest, z slowest (sdf_file.py:89-93)
    data = values.reshape(nz, ny, nx).transpose(2, 1, 0)
    return make_sdf(data, origin, resolution, device=device)


def write_sdf(path: str, sdf: SdfGrid) -> None:
    data = sdf.data.cpu().numpy()
    nx, ny, nz = data.shape
    with open(path, "w") as f:
        f.write(f"{nx} {ny} {nz}\n")
        o = sdf.origin.cpu().numpy()
        f.write(f"{o[0]} {o[1]} {o[2]}\n")
        f.write(f"{float(sdf.resolution)}\n")
        flat = data.transpose(2, 1, 0).reshape(-1)
        f.write("\n".join(str(v) for v in flat))
        f.write("\n")


def read_obj(path: str):
    """Read an OBJ mesh -> (vertices (V, 3) float64, faces (F, 3) int32).

    Accepts `f v`, `f v/vt`, `f v/vt/vn`, `f v//vn` forms; triangulates
    polygon faces by fanning. Negative (relative) indices are resolved per
    the OBJ spec.
    """
    verts: list = []
    faces: list = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, dtype=np.float64),
            np.asarray(faces, dtype=np.int32))


def write_obj(path: str, vertices, faces) -> None:
    with open(path, "w") as f:
        for v in np.asarray(vertices):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def read_off(path: str):
    """Read an OFF mesh -> (vertices, faces) (off_file.py:37-91)."""
    with open(path, "r") as f:
        header = f.readline().strip()
        if not header.startswith("OFF"):
            raise ValueError(f"{path}: not an OFF file")
        # counts may share the header line ("OFF 8 6 12")
        rest = header[3:].split()
        if rest:
            nv, nf = int(rest[0]), int(rest[1])
        else:
            counts = f.readline().split()
            nv, nf = int(counts[0]), int(counts[1])
        verts = np.array(
            [[float(x) for x in f.readline().split()[:3]] for _ in range(nv)]
        )
        faces = []
        for _ in range(nf):
            parts = [int(x) for x in f.readline().split()]
            n, idx = parts[0], parts[1:]
            for k in range(1, n - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
    return verts, np.asarray(faces, dtype=np.int32)
