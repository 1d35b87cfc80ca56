"""Conversions between array dictionaries and the port's types.

`to_arrays` flattens any dataclass scene (the port's, or the JAX package's
flax dataclasses, whose leaves `np.asarray` accepts) into a nested dict of
numpy arrays; `scene_from_arrays` builds the port's `SceneData` from such a
dict on an explicit device. Tests feed the JAX package's scene through it,
so that the two packages compute on identical data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rrt_tpu_torch.types import (BSDFTable, BlackHoleParams, EnvMap,
                                 LightTable, SceneData)

_INT_FIELDS = {"tri_bsdf", "sph_bsdf", "kind"}


def to_arrays(obj) -> dict:
    """Dataclass → dict: array leaves become numpy arrays, nested
    dataclasses become dicts, static fields (ints, tuples, None) stay."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_arrays(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif v is None or isinstance(v, (bool, int, float, str, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


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
    """Build SceneData on `device` from a `to_arrays` dict."""
    kw = {}
    for f in dataclasses.fields(SceneData):
        v = d.get(f.name)
        if f.name == "bsdfs":
            kw[f.name] = _table(BSDFTable, v, device)
        elif f.name == "lights":
            kw[f.name] = _table(LightTable, v, device)
        elif f.name in ("cluster_size", "n_live_spheres"):
            kw[f.name] = int(v)
        elif v is None:
            kw[f.name] = None
        elif f.name == "env":
            kw[f.name] = _table(EnvMap, v, device)
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

