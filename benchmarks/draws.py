"""The benchmark's random numbers, handed to the program and the reference
alike.

The system under test asks an object for every draw it makes, by name (the
``Draws`` protocol of its ``draws`` module). ``UnitDraws`` answers from
generators keyed by (run seed, unit, name, call number), so each draw is
fixed by the seed and the unit alone, whatever order the calls come in, and
the reference can make the same draw again.
"""

from __future__ import annotations

import hashlib

import torch


def derive(*parts) -> int:
    """A 63-bit seed from any parts."""
    h = hashlib.sha256(":".join(map(str, parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(device, *parts) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(*parts))
    return gen


class UnitDraws:
    def __init__(self, seed: int, unit: int, device):
        self.seed, self.unit = seed, unit
        self.device = torch.device(device)
        self._calls: dict[str, int] = {}

    def _gen(self, name: str) -> torch.Generator:
        n = self._calls.get(name, 0)
        self._calls[name] = n + 1
        return generator(self.device, self.seed, self.unit, name, n)

    def _rand(self, name, *shape):
        return torch.rand(shape, generator=self._gen(name),
                          device=self.device)

    def _below(self, name, count, shape):
        hi = torch.clamp(count, min=1).to(self.device)
        hi = hi.reshape((-1,) + (1,) * (len(shape) - 1))
        return torch.minimum((self._rand(name, *shape) * hi).long(), hi - 1)

    def seed_uniform(self, p: int, minval: float = 0.0, maxval: float = 1.0):
        return self._rand("seed_uniform", p) * (maxval - minval) + minval

    def crop_perm(self, p: int):
        return torch.randperm(p, generator=self._gen("crop_perm"),
                              device=self.device)

    def crop_windows(self, count, num_out: int):
        g = count.shape[0]
        return (self._below("window_ranks", count, (g, num_out)),
                self._below("window_start", count, (g, 1)))

    def resample(self, n: int, num_points: int, p_in: int):
        return torch.randint(0, p_in, (n, num_points),
                             generator=self._gen("resample"),
                             device=self.device)
