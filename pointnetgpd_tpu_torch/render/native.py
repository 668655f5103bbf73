"""ctypes binding of the repository's C++ rasterizer.

The port's own binding of ``native/renderer/renderer.cpp`` (a software
z-buffer rasterizer with a plain C ABI, the counterpart of
``pointnetgpd_tpu/render/native.py``). The library is built with g++ at
first use into the port's ``_build/`` (listed in ``.gitignore``), under a
name that carries a hash of the source; ``native/`` is only read. The
rasterizer runs on the host, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "renderer" / \
    "renderer.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"

_lib = None


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha1(SRC.read_bytes()).hexdigest()[:16]
    return BUILD / f"librenderer_{digest}.so"


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    d, f = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float)
    lib.render_mesh.restype = ctypes.c_int
    lib.render_mesh.argtypes = [
        d, d,                                   # proj 3x4, cam_world 3
        ctypes.c_int, ctypes.c_int,             # width, height
        d, ctypes.c_int,                        # verts, n_verts
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,   # tris, n_tris
        f, f, ctypes.POINTER(ctypes.c_uint8),   # depth, color, mask out
    ]
    _lib = lib
    return lib


def render_mesh(proj, cam_world, width: int, height: int, vertices,
                triangles):
    """Render one view: (depth (H, W) float32, color (H, W) float32, mask
    (H, W) uint8). ``proj``: the 3x4 world -> pixel projection K [R | t];
    ``cam_world``: the camera center in world coordinates."""
    lib = _load()
    proj = np.ascontiguousarray(proj, np.float64).reshape(3, 4)
    cam = np.ascontiguousarray(cam_world, np.float64).reshape(3)
    verts = np.ascontiguousarray(vertices, np.float64)
    tris = np.ascontiguousarray(triangles, np.int32)
    depth = np.zeros((height, width), np.float32)
    color = np.zeros((height, width), np.float32)
    mask = np.zeros((height, width), np.uint8)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    ret = lib.render_mesh(
        ptr(proj, ctypes.c_double), ptr(cam, ctypes.c_double), width, height,
        ptr(verts, ctypes.c_double), len(verts), ptr(tris, ctypes.c_int),
        len(tris), ptr(depth, ctypes.c_float), ptr(color, ctypes.c_float),
        ptr(mask, ctypes.c_uint8))
    if ret != 0:
        raise RuntimeError(f"render_mesh failed with code {ret}")
    return depth, color, mask
