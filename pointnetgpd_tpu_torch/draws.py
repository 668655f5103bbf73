"""Every random draw of the port, in one place.

JAX's counter-based PRNG cannot be reproduced in torch, so the port never
draws inline: each consumer asks a ``Draws`` object for the numbers it needs,
by name. The default ``Draws`` takes them from one explicit
``torch.Generator`` seeded from ``seed``. A caller (a parity test) can pass
any object with the same methods to feed in numbers drawn elsewhere; the
data-dependent draws receive the counts they depend on, so an injected
source can reproduce them exactly.

The draws, with the JAX package's line that makes them:

- ``seed_uniform(p, minval, maxval)``: (P,) uniforms that rank the GPG seed
  candidates (``grasping/samplers.py:349-356``).
- ``crop_perm(p)``: the scene shuffle of the prefix crop (``ops/crop.py:260``).
- ``crop_windows(count, num_out)``: (r (G, num_out), start (G, 1)) rank
  draws in ``[0, max(count, 1))`` (``ops/crop.py:225-229``).
- ``crop_keys(g, p_len)``: (G, P') float32 selection keys of the top-k crop
  (``ops/crop.py:357``).
- ``crop_ranks(count, num_out)``: (G, num_out) with-replacement ranks of the
  top-k crop (``ops/crop.py:376``).
- ``resample(n, num_points, p_in)``: (n, num_points) scorer resample indices
  in ``[0, p_in)`` (``inference/scorer.py:70-77``).
- ``per_sample(n)``: a source whose row i of ``crop_keys`` and
  ``crop_ranks`` is drawn for sample i alone, as the JAX package's per-sample
  crops of the GPD baseline draw them from ``split(key, n)``
  (``training/train.py:243-245``); the default source's rows are
  independent already, so it returns itself.
- ``dropout_keep(shape)``: a bool keep mask, p = 0.5 (``models/gpd.py:69-72``).

The labeling path's draws (``grasping/samplers.py`` unless named):

- ``surface_index(n_surface, n)``: (n,) antipodal contact cells in
  ``[0, n_surface)`` (``:91``).
- ``antipodal_perturb(n)``: (n, 3) uniforms that perturb the contact by
  half a cell (``:93-95``).
- ``antipodal_cone(n)``: (theta, r) uniforms, each (n,), of the axis drawn
  in the friction cone (``:109-111``).
- ``antipodal_flip(n)``: (n,) uniforms of the axis flip (``:115``).
- ``approach_perm(n, a)``: (n, a) permutations of the approach-angle
  candidates (``:129-130``).
- ``uniform_pairs(n_surface, n)``: two (n,) surface-cell draws
  (``:171-172``); ``approach_choice(n, a)``: (n,) candidates in ``[0, a)``
  (``:179-180``).
- ``gaussian_normals(n)``: (centers, axes) standard normals, each (n, 3)
  (``:203-205``).
- ``surface_subset(n, k)``: k distinct surface cells of n (``:707-709``).
- ``height_bias()``: the standard normal of the selected seed height
  (``:797-810``).
- ``randn(*shape)``: float64 standard normals, the ``rng.randn`` of
  ``grasping/random_variables.py`` (``:61-90``).
- ``next_round()``: the source of one more fixed-budget sampling round
  (``samplers.py:859``, ``pipelines/generate_dataset.py:90``, each a
  ``split`` of the key); the default source's stream continues, so it
  returns itself.

The trainer takes one ``Draws`` for its crops; its model draws nothing
else (PointNet has no dropout, and the GPD baseline trains without it, as
in the JAX package).
"""

from __future__ import annotations

import torch


class Draws:
    """Draws from an explicit ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def seed_uniform(self, p: int, minval: float = 0.0, maxval: float = 1.0):
        return self._rand(p) * (maxval - minval) + minval

    def crop_perm(self, p: int):
        return torch.randperm(p, generator=self.gen, device=self.device)

    def _below(self, count, shape):
        hi = torch.clamp(count, min=1).to(self.device)
        hi = hi.reshape((-1,) + (1,) * (len(shape) - 1))
        u = self._rand(*shape)
        return torch.minimum((u * hi).long(), hi - 1)

    def crop_windows(self, count, num_out: int):
        g = count.shape[0]
        return self._below(count, (g, num_out)), self._below(count, (g, 1))

    def crop_keys(self, g: int, p_len: int):
        return self._rand(g, p_len)

    def crop_ranks(self, count, num_out: int):
        return self._below(count, (count.shape[0], num_out))

    def resample(self, n: int, num_points: int, p_in: int):
        return torch.randint(0, p_in, (n, num_points), generator=self.gen,
                             device=self.device)

    def per_sample(self, n: int):
        return self

    def dropout_keep(self, shape):
        return self._rand(*shape) < 0.5

    def surface_index(self, n_surface: int, n: int):
        return torch.randint(0, n_surface, (n,), generator=self.gen,
                             device=self.device)

    def antipodal_perturb(self, n: int):
        return self._rand(n, 3)

    def antipodal_cone(self, n: int):
        return self._rand(n), self._rand(n)

    def antipodal_flip(self, n: int):
        return self._rand(n)

    def approach_perm(self, n: int, a: int):
        return torch.argsort(self._rand(n, a), dim=1)

    def uniform_pairs(self, n_surface: int, n: int):
        return self.surface_index(n_surface, n), self.surface_index(n_surface, n)

    def approach_choice(self, n: int, a: int):
        return torch.randint(0, a, (n,), generator=self.gen,
                             device=self.device)

    def gaussian_normals(self, n: int):
        return (torch.randn((n, 3), generator=self.gen, device=self.device),
                torch.randn((n, 3), generator=self.gen, device=self.device))

    def surface_subset(self, n: int, k: int):
        return torch.randperm(n, generator=self.gen, device=self.device)[:k]

    def height_bias(self):
        return torch.randn((), generator=self.gen, device=self.device)

    def randn(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float64).cpu().numpy()

    def next_round(self):
        return self
