"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file exports a plain C function that launches its kernel
on the stream it is given and returns ``cudaGetLastError()``. The sources are
compiled by one ``nvcc`` process each, all started together, for
``sm_90a``, and linked into one shared library under ``_build/`` (listed in
``.gitignore``). The library's name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module and have
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source flags: the panel-count scan, the crops, the k-NN normals and the
# PointNet++ sampling must not contract their arithmetic into other FMAs
# than the ones they spell out
SOURCES = {
    "gpg_counts.cu": ["-fmad=false"],
    "pointnet_trunk.cu": [],
    "point_triangle.cu": [],
    "crop_prefix.cu": ["-fmad=false"],
    "knn_normals.cu": ["-fmad=false"],
    "crop_keyed.cu": ["-fmad=false"],
    "pointnet2_sample.cu": ["-fmad=false"],
}

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # pts, P, tile_box, T, seeds, rot, fixed, scan, scan_stride, F, ns,
    # active, boxes(host), scan_is_y, out, stream
    "gpg_counts_launch": [P, I, P, I, P, P, P, P, I, I, I, P, P, I, P, P],
    # stream
    "empty_launch": [P],
    # x, B, N, C, w1, b1, w2 big, w2 small, b2, w3 big, w3 small, b3, out,
    # output width, stream
    "pointnet_trunk_launch": [P, I, I, I, P, P, P, P, P, P, P, P, P, I, P],
    # pts, n_blocks, tri_data, sup_data, n_sup, out, stats (or null), stream
    "point_triangle_launch": [P, I, P, P, I, P, P, P],
    # pc, cloud_stride, perm, P, p_pad, G, centers, rot, box_lo, box_hi,
    # bits, incl, count, stream
    "crop_count_launch": [P, I, P, I, I, I, P, P, P, P, P, P, P, P],
    # pc, cloud_stride, perm, P, p_pad, G, centers, rot, bits, incl, count,
    # r, start, num_out, out, stream
    "crop_select_launch": [P, I, P, I, I, I, P, P, P, P, P, P, P, I, P, P],
    # pts, B, P, k, cam (or null), cam_x, cam_y, cam_z, out, idx_out (or
    # null), stream
    "knn_normals_launch": [P, I, I, I, P, F, F, F, P, P, P],
    # pc, cloud_stride, P, seg_len, G, centers, rot, box_lo, box_hi, keys,
    # kk, scratch (or null), perm, count, stream
    "crop_keyed_select_launch": [P, I, I, I, I, P, P, P, P, P, I, P, P, P, P],
    # pc, cloud_stride, P, seg_len, G, centers, rot, perm, kk, count, r,
    # num_out, out, stream
    "crop_keyed_gather_launch": [P, I, I, I, I, P, P, P, I, P, P, I, P, P],
    # xyz, B, N, npoint, out, stream
    "pn2_fps_launch": [P, I, I, I, P, P],
    # xyz, B, N, centroids, S, r2, nsample, out, stream
    "pn2_ball_query_launch": [P, I, I, P, I, F, I, P, P],
}

_LIB = None
build_seconds: float | None = None   # wall time of the build this process ran
ptxas_log: str = ""                   # nvcc -Xptxas -v output of that build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha1()
    for name, flags in sorted(SOURCES.items()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
        h.update(" ".join(ARCH + COMMON + flags).encode())
    for extra in sorted(CSRC.glob("*.cuh")):
        h.update(extra.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path. Raises with the compiler's output on failure."""
    global build_seconds, ptxas_log
    so = BUILD_DIR / f"libpngpd_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, flags in SOURCES.items():
        obj = BUILD_DIR / (Path(name).stem + f".{os.getpid()}.o")
        cmd = [nvcc, *ARCH, *COMMON, *flags, "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs, failed = [], [], []
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(name)
    ptxas_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{ptxas_log}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    (BUILD_DIR / "ptxas.log").write_text(ptxas_log)
    build_seconds = time.perf_counter() - t0
    return so


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, args in SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
