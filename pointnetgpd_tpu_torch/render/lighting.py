"""Material and lighting property containers for the renderer.

(reference: meshpy/meshpy/lighting.py:9-83 — MaterialProperties /
LightingProperties structs fed to the meshrender module. The native
rasterizer shades with a headlight lambertian model; these containers carry
the parameters for API parity and scale the output intensity.)

A copy of ``pointnetgpd_tpu/render/lighting.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MaterialProperties:
    color: tuple = (0.5, 0.5, 0.5)
    ambient: float = 0.2
    diffuse: float = 0.8
    specular: float = 0.0
    shininess: float = 0.0

    def shade(self, lambertian: float) -> float:
        """Intensity for a |n.v| lambertian term under a headlight."""
        return min(self.ambient + self.diffuse * lambertian, 1.0)


@dataclass(frozen=True)
class LightingProperties:
    ambient: float = 0.2
    diffuse: float = 0.8
    specular: float = 0.0
    n_lights: int = 1
