"""Operations of one labeling round, counted from the mix's parameters and
the reference algorithm (``reference/label.py``), as the cell's mfu defines
them: per attempt the surface normal at the drawn point, the two contact
searches along its axis and the ladder's two (4 x ``num_samples_loa``
lookups, the count the pipeline passes to both) and one closure test per
rung. The approach checks, the contacts' normals and the second closing that the
algorithm also makes are not counted, so the share is a lower bound of the
work done. Counts are float operations, a multiply-add as 2:

- a lookup (trilinear, 8 corners): 3 fractions, 3 complements, 2 products
  a corner's weight, 8 products with the values, 7 sums: 37;
- a surface normal: 29 lookups (the point, its 27 sphere points with
  itself, the probe) and the plane fit: the mean of 27 points (84), their
  centring (81), the 6 entries of the scatter (324), a 3 x 3 symmetric
  eigen-solve counted as 100;
- a closure test: two angles, each a dot, a norm, a division and an
  arccos, counted as 40 in all.
"""

from __future__ import annotations

LOOKUP = 37
NORMAL = 29 * LOOKUP + 84 + 81 + 324 + 100
CLOSURE = 40


def attempt_flops(t: dict, rungs: int) -> int:
    return NORMAL + 4 * t["num_samples_loa"] * LOOKUP + rungs * CLOSURE


def unit_flops(t: dict, rungs: int) -> int:
    return t["num_attempts"] * attempt_flops(t, rungs)
