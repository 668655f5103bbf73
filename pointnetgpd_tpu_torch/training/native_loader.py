"""ctypes binding + batcher for the repository's native C++ data loader.

The port's own binding of ``native/loader/loader.cpp`` (threaded .npy reads
with a cloud cache, random grasp/view selection, fixed-shape batch assembly
in C++), the counterpart of ``pointnetgpd_tpu/training/native_loader.py``.
The library is built with g++ at first use into the port's ``_build/``
(listed in ``.gitignore``), under a name that carries a hash of the source;
``native/`` is only read. ``NativeBatcher`` has the ``OneViewBatcher``
interface and produces the batch tuple the fused train step consumes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from .data import labels_from_scores

_SRC = Path(__file__).resolve().parents[2] / "native" / "loader" / "loader.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"


def _load():
    """Build (if needed) and load the loader library; declare its C API."""
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libloader_{digest}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-pthread", "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_uint64, ctypes.c_int]
    lib.loader_add_object.restype = ctypes.c_int64
    lib.loader_add_object.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_char_p]
    lib.loader_next_batch.restype = ctypes.c_int
    lib.loader_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.loader_num_objects.restype = ctypes.c_int64
    lib.loader_num_objects.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeBatcher:
    """C++-backed batch source with the OneViewBatcher interface.

    Per sample: random object -> random grasp row + random view cloud,
    subsampled to ``cloud_points``; labels and weights from the score
    columns (``labels_from_scores``). The transforms are identity: the
    native loader samples objects internally, so it expects grasp files
    already in the cloud frame (as the JAX package's binding does).
    """

    GRASP_COLS = 12

    def __init__(self, index, batch_size: int, cloud_points: int = 20000,
                 num_classes: int = 2, thresh_good: float = 0.6,
                 thresh_bad: float = 0.6, seed: int = 0,
                 n_threads: int = 0):
        self._lib = lib = _load()
        self._handle = lib.loader_create(cloud_points, self.GRASP_COLS,
                                         seed, n_threads)
        self.batch_size = batch_size
        self.cloud_points = cloud_points
        self.num_classes = num_classes
        self.thresh_good = thresh_good
        self.thresh_bad = thresh_bad
        self._batch_counter = 0
        n_ok = 0
        for obj in index.objects:
            files = index.cloud_files.get(index.transform[obj][0], [])
            if files and lib.loader_add_object(
                    self._handle, index.grasp_files[obj].encode(),
                    "\n".join(files).encode()) > 0:
                n_ok += 1
        if n_ok == 0:
            self.close()
            raise ValueError("no loadable objects")
        self._identity = np.tile(np.eye(4, dtype=np.float32),
                                 (batch_size, 1, 1))

    def next_batch(self):
        b = self.batch_size
        grasps = np.zeros((b, self.GRASP_COLS), np.float32)
        clouds = np.zeros((b, self.cloud_points, 3), np.float32)
        scores = np.zeros((b, 2), np.float32)
        self._batch_counter += 1
        ptr = ctypes.POINTER(ctypes.c_float)
        ret = self._lib.loader_next_batch(
            self._handle, b, self._batch_counter, grasps.ctypes.data_as(ptr),
            clouds.ctypes.data_as(ptr), scores.ctypes.data_as(ptr))
        if ret == 1:
            raise RuntimeError("native loader has no objects")
        labels, weights = labels_from_scores(
            scores[:, 0], scores[:, 1], self.thresh_good, self.thresh_bad,
            self.num_classes)
        if ret == 2:  # some cloud loads failed: mask those samples
            weights = weights * clouds.any(axis=(1, 2)).astype(np.float32)
        return grasps, clouds, self._identity, labels, weights

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None
