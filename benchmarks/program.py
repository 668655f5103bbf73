"""What the benchmark takes from the system under test: its model class,
loaded with the benchmark's weights. Imported only inside the kinds' cells, so
that the harness's own files load without the program."""

from __future__ import annotations

import random

import torch

from .draws import derive


def pointnet_cls(config: dict, params: dict, device, *, train: bool = False):
    """The program's PointNetCls on ``device`` with ``params`` (reference
    names) copied in."""
    from pointnetgpd_tpu_torch.models.pointnet import PointNetCls

    with torch.device(device):
        model = PointNetCls(num_points=config["num_points"],
                            input_chann=config["input_chann"], k=config["k"])
    missing, unexpected = model.load_state_dict(params, strict=False)
    if unexpected or any(not m.endswith("num_batches_tracked")
                         for m in missing):
        raise RuntimeError(f"weights do not fit the program's model: "
                           f"missing {missing}, unexpected {unexpected}")
    return model.train(train)


class Sample:
    """``k`` of a stream of units kept for the check: the last one, and
    ``k - 1`` drawn uniformly from the rest by reservoir sampling from the
    seed, so that what is kept stays small however long the window."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(derive(seed, "check"))
        self.m = max(k - 1, 0)
        self.kept: list = []
        self.seen = 0
        self.last = None

    def offer(self, i: int, item) -> None:
        if self.last is not None:
            self._reservoir(self.last)
        self.last = [i, item]

    def _reservoir(self, entry) -> None:
        if len(self.kept) < self.m:
            self.kept.append(entry)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.m:
                self.kept[j] = entry
        self.seen += 1

    def entries(self) -> list:
        """[unit, item] pairs, in unit order (mutable)."""
        out = self.kept + ([self.last] if self.last is not None else [])
        return sorted(out, key=lambda e: e[0])


def free_cuda():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
