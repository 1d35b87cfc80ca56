"""Array dictionaries to the reference's types: a frozen copy of the
port's `rrt_tpu_torch/convert.py` without its Kerr pieces and its
environment map.
`scene_from_arrays` builds `SceneData` from `scene.build`'s dict on an
explicit device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cardbench.ref.types import (BSDFTable, BlackHoleParams, LightTable,
                                 SceneData)

_INT_FIELDS = {"tri_bsdf", "sph_bsdf", "kind"}


def _tensor(name, a, device):
    a = np.asarray(a)
    dtype = torch.int32 if name in _INT_FIELDS else torch.float32
    return torch.tensor(a, dtype=dtype, device=device)


def _table(cls, d: dict, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        kw[f.name] = tuple(int(k) for k in v) if f.name == "kind_host" \
            else _tensor(f.name, v, device)
    return cls(**kw)


def scene_from_arrays(d: dict, device) -> SceneData:
    """Build SceneData on `device` from `build._scene_arrays`' dict."""
    kw = {}
    for f in dataclasses.fields(SceneData):
        v = d.get(f.name)
        if f.name == "bsdfs":
            kw[f.name] = _table(BSDFTable, v, device)
        elif f.name == "lights":
            kw[f.name] = _table(LightTable, v, device)
        elif f.name == "n_live_spheres":
            kw[f.name] = int(v)
        else:
            kw[f.name] = _tensor(f.name, v, device)
    return SceneData(**kw)


def black_hole_from_arrays(position, radius, delta_theta, device,
                           enabled: bool = True) -> BlackHoleParams:
    """BlackHoleParams on `device` from plain numbers or arrays."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return BlackHoleParams(position=f32(position).reshape(3),
                           radius=f32(radius).reshape(()),
                           delta_theta=f32(delta_theta).reshape(()),
                           enabled=bool(enabled))
