"""Core types of the port: rays, hits and the flat struct-of-arrays scene.

Dataclasses of tensors with the field names, shapes and dtypes of
`rrt_tpu/types.py`, so that a test can hand both packages the same arrays.
Every type has `.to(device)`; nothing here picks a device on its own.
"""
from __future__ import annotations

import dataclasses

import torch

# the BSDF and light type tags of the kinds that the configured scenes
# hold (rrt_tpu/types.py's values); the reference covers no other kind
BSDF_DIFFUSE = 0
BSDF_EMISSION = 5
LIGHT_AREA = 4


class _Tensors:
    """`.to(device)` and `.replace(**kw)` for dataclasses of tensors:
    tensor fields move, nested types recurse, static fields are kept."""

    def to(self, device):
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, _Tensors)):
                v = v.to(device)
            kw[f.name] = v
        return type(self)(**kw)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Rays(_Tensors):
    """A flat batch of rays; all fields share the leading batch axes."""

    o: torch.Tensor        # (..., 3) origin
    d: torch.Tensor        # (..., 3) unit direction
    min_t: torch.Tensor    # (...,)
    max_t: torch.Tensor    # (...,)


@dataclasses.dataclass
class Hit(_Tensors):
    """Closest-hit record: world hit point and outgoing direction, since a
    marched ray has no single parameter along the original ray."""

    hit: torch.Tensor       # (...,) bool
    t: torch.Tensor         # (...,) chord-local t of the winning segment
    p: torch.Tensor         # (..., 3) world hit point
    n: torch.Tensor         # (..., 3) interpolated shading normal (not unit)
    w_out: torch.Tensor     # (..., 3) -chord direction at the hit
    prim_id: torch.Tensor   # (...,) int32: triangle ids, then sphere ids
    bsdf_id: torch.Tensor   # (...,) int32 row of BSDFTable (-1 = none)


@dataclasses.dataclass
class BSDFTable(_Tensors):
    """One row per material instance."""

    kind: torch.Tensor           # (B,) int32 BSDF_* tag
    reflectance: torch.Tensor    # (B, 3)
    transmittance: torch.Tensor  # (B, 3)
    emission: torch.Tensor       # (B, 3)
    eta: torch.Tensor            # (B, 3)
    k: torch.Tensor              # (B, 3)
    alpha: torch.Tensor          # (B,)
    ior: torch.Tensor            # (B,)


@dataclasses.dataclass
class LightTable(_Tensors):
    """One row per scene light; `kind_host` is the host copy of `kind`
    that the integrator's per-light loop reads."""

    kind: torch.Tensor       # (L,) int32
    radiance: torch.Tensor   # (L, 3)
    position: torch.Tensor   # (L, 3)
    direction: torch.Tensor  # (L, 3) area: emission dir; directional: to light
    dim_x: torch.Tensor      # (L, 3) area light edges
    dim_y: torch.Tensor      # (L, 3)
    area: torch.Tensor       # (L,)
    kind_host: tuple = ()


@dataclasses.dataclass
class BlackHoleParams(_Tensors):
    """Schwarzschild hole: `radius` is both horizon and Schwarzschild
    radius, as in the reference."""

    position: torch.Tensor     # (3,)
    radius: torch.Tensor       # ()
    delta_theta: torch.Tensor  # ()
    enabled: bool = True


@dataclasses.dataclass
class SceneData(_Tensors):
    """Flat triangle / sphere / material / light tables. Triangles come
    first in the primitive id space, then spheres."""

    tri_v0: torch.Tensor    # (T, 3); padded rows have bsdf -1
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_n0: torch.Tensor    # (T, 3) vertex normals
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_bsdf: torch.Tensor  # (T,) int32
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_bsdf: torch.Tensor    # (S,) int32
    bsdfs: BSDFTable
    lights: LightTable
    # live sphere rows (dead padding rows sit at the tail); -1 = all live
    n_live_spheres: int = -1

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]

    @property
    def n_spheres(self):
        return self.sph_center.shape[0]

    @property
    def n_prims(self):
        return self.n_tris + self.n_spheres

    @property
    def device(self):
        return self.tri_v0.device
