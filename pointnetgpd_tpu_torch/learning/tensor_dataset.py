"""Chunked on-disk tensor dataset (reference:
dex-net/src/dexnet/learning/tensor_dataset.py:41-456): fixed-capacity tensors
flushed to per-field .npz chunk files, with global-index reads across chunks.
Used for GQ-CNN-style rendered-image datasets.

The port's own copy of ``pointnetgpd_tpu/learning/tensor_dataset.py`` (numpy only).
"""

from __future__ import annotations

import json
import os

import numpy as np


class Tensor:
    """Fixed-capacity numpy buffer (tensor_dataset.py:41-143)."""

    def __init__(self, shape, dtype=np.float32):
        self.capacity = shape[0]
        self.data = np.zeros(shape, dtype=dtype)
        self.cur_index = 0

    @property
    def is_full(self):
        return self.cur_index >= self.capacity

    @property
    def size(self):
        return self.cur_index

    def add(self, datapoint):
        if self.is_full:
            raise ValueError("Tensor is full")
        self.data[self.cur_index] = datapoint
        self.cur_index += 1

    def reset(self):
        self.cur_index = 0

    def __getitem__(self, i):
        if i >= self.cur_index:
            raise IndexError(i)
        return self.data[i]


class TensorDatapoint(dict):
    """A dict of named arrays (tensor_dataset.py:145-160)."""


class TensorDataset:
    """Append-only dataset of TensorDatapoints, chunked to disk
    (tensor_dataset.py:162-456).

    config: {field_name: {"shape": [...], "dtype": "float32"}}.
    Files: {dir}/tensors/{field}_{chunk:05d}.npz + config.json.
    """

    def __init__(self, dataset_dir: str, config: dict,
                 datapoints_per_file: int = 100):
        self.dataset_dir = dataset_dir
        self.tensor_dir = os.path.join(dataset_dir, "tensors")
        os.makedirs(self.tensor_dir, exist_ok=True)
        self.config = config
        self.datapoints_per_file = datapoints_per_file
        self.num_datapoints = 0
        self._cur_chunk = 0
        self._tensors = {
            name: Tensor((datapoints_per_file, *spec.get("shape", [])),
                         np.dtype(spec.get("dtype", "float32")))
            for name, spec in config.items()
        }
        with open(os.path.join(dataset_dir, "config.json"), "w") as f:
            json.dump({"fields": config,
                       "datapoints_per_file": datapoints_per_file}, f)

    # ------------------------------------------------------------------
    def datapoint_template(self) -> TensorDatapoint:
        return TensorDatapoint({
            name: np.zeros(spec.get("shape", []),
                           np.dtype(spec.get("dtype", "float32")))
            for name, spec in self.config.items()
        })

    def add(self, datapoint: TensorDatapoint):
        for name, tensor in self._tensors.items():
            tensor.add(datapoint[name])
        self.num_datapoints += 1
        if next(iter(self._tensors.values())).is_full:
            self.flush()

    def flush(self):
        size = next(iter(self._tensors.values())).size
        if size == 0:
            return
        for name, tensor in self._tensors.items():
            path = os.path.join(self.tensor_dir,
                                f"{name}_{self._cur_chunk:05d}.npz")
            np.savez_compressed(path, arr=tensor.data[:size])
            tensor.reset()
        self._cur_chunk += 1
        self._write_meta()

    def _write_meta(self):
        with open(os.path.join(self.dataset_dir, "meta.json"), "w") as f:
            json.dump({"num_datapoints": self.num_datapoints,
                       "num_chunks": self._cur_chunk}, f)

    # ------------------------------------------------------------------
    def datapoint(self, index: int) -> TensorDatapoint:
        if index >= self.num_datapoints:
            raise IndexError(index)
        chunk = index // self.datapoints_per_file
        offset = index % self.datapoints_per_file
        if chunk >= self._cur_chunk:  # still in memory
            return TensorDatapoint({
                name: tensor[offset] for name, tensor in self._tensors.items()
            })
        out = TensorDatapoint()
        for name in self._tensors:
            path = os.path.join(self.tensor_dir, f"{name}_{chunk:05d}.npz")
            with np.load(path) as z:
                out[name] = z["arr"][offset]
        return out

    def __len__(self):
        return self.num_datapoints

    @classmethod
    def open(cls, dataset_dir: str) -> "TensorDataset":
        with open(os.path.join(dataset_dir, "config.json")) as f:
            meta = json.load(f)
        ds = cls(dataset_dir, meta["fields"], meta["datapoints_per_file"])
        meta_path = os.path.join(dataset_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                m = json.load(f)
            ds.num_datapoints = m["num_datapoints"]
            ds._cur_chunk = m["num_chunks"]
        return ds
