"""float32 arithmetic in the association the reference computes.

The JAX package's CPU build contracts ``a * b + c`` into fused multiply-adds.
Where a result feeds a discrete decision (a neighbor chosen among points at
equal distance on a voxel grid, a point on a panel-box bound), the port must
round the same way, or the two stacks pick different neighbors and count
different points. These helpers spell out those roundings:

- ``fma(a, b, c)``: ``a * b + c`` rounded once to float32. The product of two
  float32 values is exact in float64, so one float64 add and one rounding
  give the fused result (a double rounding can differ in about 1 of 2**28
  cases, far below anything the tests can see).
- ``dot3``: a 3-term reduction, ``fma(a2, b2, fma(a1, b1, a0 * b0))``, the
  order of a dot product or ``sum(x * x)`` over a length-3 axis.
- ``lin3``: a 3-term add chain ``a0 * x + a1 * y + a2 * z``, contracted as
  ``fma(a2, z, fma(a0, x, a1 * y))``.
- ``sqrt``: the correctly rounded float32 square root, as XLA and CUDA give
  it. Torch's float32 ``sqrt`` on the CPU is MKL's vector-math kernel, off
  by one ulp in about 1 of 150 cases, so on the CPU it goes through float64
  (the float64 root rounded to float32 is the correctly rounded float32
  root; ``tools/cpu_roots_probe.py exhaustive`` checks every positive
  float32).
- ``rsqrt``: the correctly rounded float32 reciprocal square root on the
  CPU (float64, then rounded), ``torch.rsqrt`` elsewhere. JAX's jitted CPU
  ``rsqrt`` is XLA's ``vrsqrtps`` estimate refined by two Newton steps: a
  table of the CPU's own, which no torch op reaches. It lies within one
  ulp of the correctly rounded value, and agrees with it on more values
  than with torch's float32 ``1 / sqrt(x)``; what ``rsqrt`` feeds,
  BatchNorm, is held to the JAX package by a tolerance.

- ``f64(fn, x, ...)``: a float32 function evaluated in float64 and rounded
  to float32. Torch's float32 transcendentals (sin, cos, arccos, ...),
  reductions and small matmuls round differently on the card and on the
  CPU; in float64 and rounded once, both give the same bits (but for a
  double rounding, about 1 case in 2**29), so the labeling path's card
  route and CPU route take the same discrete decisions.

The CUDA kernels issue the same operations explicitly (``__fmaf_rn``), so the
kernel and its plain version agree bit for bit.

Torch's CPU ``sqrt`` (float32 and float64), ``exp``, ``sin`` and the other
vector-math functions call MKL, which picks its kernel from a CPU type that
it detects on its first call in a process. Threads that enter that first
call together can read the detector's unmapped CPU code, and run MKL's
low-accuracy AVX2 kernel on their share of the tensor (11 correct bits for
a float32 root). The package's ``__init__`` makes one such call on one
element, so the detection has run on one thread before any of the port's
calls (ROADMAP Queue C item 24). ``rsqrt``, ``linalg.norm`` and the basic
arithmetic do not call MKL.
"""

from __future__ import annotations

import torch


def _f64(v):
    # Python scalars enter as float32 first, as JAX's weak-typed scalars do
    return torch.as_tensor(v, dtype=torch.float32).to(torch.float64)


def fma(a, b, c):
    """float32 ``a * b + c`` with a single rounding."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


def dot3(a0, b0, a1, b1, a2, b2):
    """``a0*b0 + a1*b1 + a2*b2`` in reduction order."""
    return fma(a2, b2, fma(a1, b1, a0 * b0))


def lin3(a0, x, a1, y, a2, z):
    """``a0*x + a1*y + a2*z`` in add-chain order."""
    return fma(a2, z, fma(a0, x, a1 * y))


def sumsq3(v):
    """``sum(v * v, axis=-1)`` for (..., 3) float32 ``v``."""
    return dot3(v[..., 0], v[..., 0], v[..., 1], v[..., 1],
                v[..., 2], v[..., 2])


def sqrt(x):
    """Correctly rounded float32 square root."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def rsqrt(x):
    """Correctly rounded float32 reciprocal square root on the CPU."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.rsqrt(x.to(torch.float64)).to(torch.float32)
    return torch.rsqrt(x)


def norm3(v):
    """``sqrt(sum(v * v, axis=-1))`` for (..., 3) float32 ``v``, rounded as
    ``jnp.linalg.norm`` under ``jit``."""
    return sqrt(sumsq3(v))


def f64(fn, *xs):
    """``fn(*xs)`` of float32 tensors computed in float64, rounded to
    float32."""
    return fn(*(x.to(torch.float64) for x in xs)).to(torch.float32)


def dot3v(a, b):
    """``sum(a * b, axis=-1)`` for (..., 3) float32 ``a``, ``b``."""
    return dot3(a[..., 0], b[..., 0], a[..., 1], b[..., 1],
                a[..., 2], b[..., 2])
