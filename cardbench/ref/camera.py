"""Orbit camera with pinhole ray generation (the port's copy of
`rrt_tpu/scene/camera.py`, without the thin lens that the configured
cells do not use).

The camera state lives on the host as numpy floats; `generate_rays`
builds torch tensors on the device of the screen coordinates it is given, reading the camera frame from device tensors
made once per device (`frame`), so that a captured render pass makes no
host copy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cardbench.ref.collada import CameraInfo
from cardbench.ref.types import Rays


def _radians(d):
    return d * math.pi / 180.0


def _degrees(r):
    return r * 180.0 / math.pi


@dataclasses.dataclass
class Camera:
    h_fov: float = 50.0
    v_fov: float = 35.0
    n_clip: float = 0.001
    f_clip: float = 1000.0
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    target_pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    phi: float = 0.0
    theta: float = 0.0
    r: float = 1.0
    min_r: float = 0.0
    max_r: float = 1e9
    c2w: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    screen_w: int = 800
    screen_h: int = 600
    screen_dist: float = 1.0
    ar: float = 1.0

    def configure(self, info: CameraInfo, screen_w: int, screen_h: int):
        """Fit the FoV to the screen aspect ratio (camera.cpp:22-40)."""
        self.screen_w, self.screen_h = screen_w, screen_h
        self.n_clip, self.f_clip = info.n_clip, info.f_clip
        self.h_fov, self.v_fov = info.h_fov, info.v_fov
        ar1 = math.tan(_radians(self.h_fov) / 2) / math.tan(
            _radians(self.v_fov) / 2)
        self.ar = screen_w / screen_h
        if ar1 < self.ar:
            self.h_fov = 2 * _degrees(
                math.atan(math.tan(_radians(self.v_fov) / 2) * self.ar))
        elif ar1 > self.ar:
            self.v_fov = 2 * _degrees(
                math.atan(math.tan(_radians(self.h_fov) / 2) / self.ar))
        self.screen_dist = screen_h / (2.0 * math.tan(_radians(self.v_fov) / 2))

    def set_screen_size(self, screen_w: int, screen_h: int):
        """Resize after `configure`: the FoV is re-derived from the frozen
        screen distance (camera.cpp:68-74). The reference configures at
        800×600 and then resizes to `-r W H`, which changes the effective
        FoV; the scene build reproduces that."""
        self.screen_w, self.screen_h = screen_w, screen_h
        self.ar = screen_w / screen_h
        self.h_fov = 2 * _degrees(math.atan(screen_w / (2 * self.screen_dist)))
        self.v_fov = 2 * _degrees(math.atan(screen_h / (2 * self.screen_dist)))

    def place(self, target, phi, theta, r, min_r, max_r):
        """Orbit placement (camera.cpp:42-54, compute_position:96-119)."""
        self.r = min(max(r, min_r), max_r)
        self.phi = phi + 1e-6 if math.sin(phi) == 0 else phi
        self.theta = theta
        self.target_pos = np.asarray(target, dtype=np.float64)
        self.min_r, self.max_r = min_r, max_r
        self._compute_position()

    def _compute_position(self):
        sin_phi = math.sin(self.phi)
        if sin_phi == 0:
            self.phi += 1e-6
            sin_phi = math.sin(self.phi)
        dir_to_cam = np.array([
            self.r * sin_phi * math.sin(self.theta),
            self.r * math.cos(self.phi),
            self.r * sin_phi * math.cos(self.theta),
        ])
        self.pos = self.target_pos + dir_to_cam
        up = np.array([0.0, 1.0 if sin_phi > 0 else -1.0, 0.0])
        x = np.cross(up, dir_to_cam)
        x /= np.linalg.norm(x)
        y = np.cross(dir_to_cam, x)
        y /= np.linalg.norm(y)
        self.c2w = np.stack(
            [x, y, dir_to_cam / np.linalg.norm(dir_to_cam)], axis=1)

    def _screen_dirs(self, xy):
        """Camera-space directions through the screen plane at z = -1."""
        bx = math.tan(_radians(self.h_fov) / 2)
        by = math.tan(_radians(self.v_fov) / 2)
        sx = (2.0 * xy[..., 0] - 1.0) * bx
        sy = (2.0 * xy[..., 1] - 1.0) * by
        return torch.stack([sx, sy, -torch.ones_like(sx)], dim=-1)

    def _rays(self, o, d, xy):
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        shape = xy.shape[:-1]
        return Rays(
            o=torch.broadcast_to(o, d.shape),
            d=d,
            min_t=torch.full(shape, self.n_clip, dtype=xy.dtype,
                             device=xy.device),
            max_t=torch.full(shape, self.f_clip, dtype=xy.dtype,
                             device=xy.device))

    def frame(self, dtype, device):
        """(c2w (3,3), pos (3,)) as tensors of `dtype` on `device`, made on
        first use and kept; when the host values have changed since, the
        kept tensors are refreshed in place, so that a CUDA graph that
        reads them sees the camera as it is at its next replay's render."""
        cache = self.__dict__.setdefault("_frames", {})
        host = (np.asarray(self.c2w, np.float64).copy(),
                np.asarray(self.pos, np.float64).copy())
        key = (torch.device(device), dtype)
        kept = cache.get(key)
        if kept is None:
            kept = cache[key] = [host] + [torch.as_tensor(a, dtype=dtype,
                                                          device=device)
                                          for a in host]
        elif not all(np.array_equal(a, b) for a, b in zip(kept[0], host)):
            kept[0] = host
            kept[1].copy_(torch.as_tensor(host[0], dtype=dtype))
            kept[2].copy_(torch.as_tensor(host[1], dtype=dtype))
        return kept[1], kept[2]

    def generate_rays(self, xy: torch.Tensor) -> Rays:
        """Pinhole rays for normalized screen coordinates xy ∈ [0,1]²
        (..., 2), on xy's device (part1_code.cpp:182-187)."""
        c2w, pos = self.frame(xy.dtype, xy.device)
        d = self._screen_dirs(xy) @ c2w.T
        return self._rays(pos, d, xy)
