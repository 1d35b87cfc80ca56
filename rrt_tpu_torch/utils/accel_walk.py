"""Interactive walk of the acceleration structure, the headless counterpart
of the reference's VISUALIZE-mode BVH navigation. The port of
`rrt_tpu/utils/accel_walk.py`.

The reference keeps a selection stack over its binary BVH and moves it with
the arrow keys: up pops to the parent, left pushes the left child, right
the right child (pathtracer.cpp:520-534); `visualize_accel()` draws every
node box dim, the selection highlighted, its children brighter and the
selection's primitives (pathtracer.cpp:330-423).

Here the structure is the trace kernel's own: the part → supercluster →
cluster → triangle tables of `ops/trace_kernel.TraceTables`. Part p's
superclusters are rows [p·spp, (p+1)·spp), supercluster u's clusters are
[u·SUP, (u+1)·SUP), cluster k's triangles are [k·cs_k, (k+1)·cs_k), so
every count is the tables' own, padding included; padded rows and empty
boxes are not drawn. The keys over this N-ary tree:

  up    pop to the parent (the root stays put, as in the reference)
  left  descend into the first child
  right advance to the next sibling, wrapping

`render()` rasterizes the reference's view: every box of the selected
level dim, the selection's children white, the selection's triangles'
edges and the selection's box orange and thick, projected with the render
camera along straight lines (the reference's GL draw ignores curvature
too), in the frame's y-up pixels. `--serve` serves it live
(`utils/serve.py`: /accel.png and POST /control {"accel": ...}).
"""
from __future__ import annotations

import math

import numpy as np

from rrt_tpu_torch.ops.trace_kernel import BIG, SUP, build_tables

LEVELS = ("root", "part", "supercluster", "cluster")


class KernelHierarchy:
    """The trace kernel's culling tables of a scene, on the host."""

    def __init__(self, scene):
        tab = build_tables(scene, None)
        box = lambda t: t[:, :6].detach().cpu().numpy().astype(np.float64)
        self.n_parts, self.spp, self.cs = tab.n_parts, tab.spp, tab.cs_k
        self.n_tris = scene.n_tris
        self.part, self.sup, self.cl = box(tab.part), box(tab.sup), \
            box(tab.cl)
        v = [a.detach().cpu().numpy().astype(np.float64)
             for a in (scene.tri_v0, scene.tri_v1, scene.tri_v2)]
        self.tris = np.stack(v, axis=1)                   # (T, 3, 3)
        self.live = scene.tri_bsdf.cpu().numpy() >= 0
        live_parts = self.part[self.part[:, 0] < BIG]
        self.root = np.concatenate([live_parts[:, :3].min(axis=0),
                                    live_parts[:, 3:].max(axis=0)])[None]

    def boxes(self, level) -> np.ndarray:
        """(n, 6) [lo xyz, hi xyz] rows of a level; an empty box is a
        point at +BIG."""
        return (self.root, self.part, self.sup, self.cl)[level]

    def n_children(self, level, idx) -> int:
        return (self.n_parts, self.spp, SUP, 0)[level]

    def child_index(self, level, idx, child) -> int:
        """Global index of `child` under node (level, idx)."""
        return idx * self.n_children(level, idx) + child

    def tri_range(self, level, idx):
        """[start, stop) of the scene's triangle rows under (level, idx)."""
        w = (0, self.spp * SUP * self.cs, SUP * self.cs, self.cs)[level]
        start, stop = (0, self.n_tris) if level == 0 else (idx * w,
                                                            (idx + 1) * w)
        return min(start, self.n_tris), min(stop, self.n_tris)


class AccelWalk:
    """Selection-stack walk and wireframe rasterizer."""

    def __init__(self, scene, camera):
        self.h = KernelHierarchy(scene)
        self.stack = [(0, 0)]                # (level, index), root first
        self.camera = camera

    @property
    def selected(self):
        return self.stack[-1]

    def key(self, action: str) -> bool:
        """Apply one navigation key; True if the selection moved
        (pathtracer.cpp:520-534: up pops, left pushes a child, right
        moves to the sibling)."""
        level, idx = self.stack[-1]
        if action == "up":
            if len(self.stack) > 1:
                self.stack.pop()
                return True
            return False
        if action == "left":
            if self.h.n_children(level, idx) > 0:
                self.stack.append(
                    (level + 1, self.h.child_index(level, idx, 0)))
                return True
            return False
        if action == "right":
            if len(self.stack) > 1:
                plevel, pidx = self.stack[-2]
                nsib = self.h.n_children(plevel, pidx)
                base = self.h.child_index(plevel, pidx, 0)
                self.stack[-1] = (level, base + (idx - base + 1) % nsib)
                return True
            return False
        return False

    # ------------------------------------------------------------ drawing

    def _project(self, pts):
        """World → pixel (straight-line pinhole, as the GL draw), y up.
        Returns (N, 2) float pixels and whether each is in front of the
        camera."""
        cam = self.camera
        p = (np.asarray(pts, np.float64)
             - np.asarray(cam.pos, np.float64)) @ np.asarray(cam.c2w,
                                                               np.float64)
        z = p[:, 2]
        ok = z < -1e-9
        zs = np.where(ok, z, -1.0)
        bx = math.tan(math.radians(cam.h_fov) / 2)
        by = math.tan(math.radians(cam.v_fov) / 2)
        x01 = (p[:, 0] / (-zs) / bx + 1.0) / 2.0
        y01 = (p[:, 1] / (-zs) / by + 1.0) / 2.0
        return np.stack([x01 * cam.screen_w, y01 * cam.screen_h], axis=1), ok

    @staticmethod
    def _line(img, a, b, color, alpha=1.0):
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1))
        n = min(n, 4 * max(img.shape[0], img.shape[1]))
        t = np.linspace(0.0, 1.0, n + 1)
        xs = np.clip((a[0] + (b[0] - a[0]) * t).astype(int),
                     0, img.shape[1] - 1)
        ys = np.clip((a[1] + (b[1] - a[1]) * t).astype(int),
                     0, img.shape[0] - 1)
        img[ys, xs] = (1 - alpha) * img[ys, xs] + alpha * np.asarray(color)

    def _draw_box(self, img, row, color, alpha, thick=1):
        lo, hi = row[:3], row[3:6]
        if not (np.all(np.isfinite(row)) and np.all(lo <= hi)
                and lo[0] < BIG):               # an empty or padded box
            return
        c = np.array([[x, y, z] for z in (lo[2], hi[2])
                      for y in (lo[1], hi[1]) for x in (lo[0], hi[0])])
        px, ok = self._project(c)
        edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
                 (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
        for i, j in edges:
            if ok[i] and ok[j]:
                for dx in range(thick):
                    self._line(img, px[i] + dx, px[j] + dx, color, alpha)

    def render(self, base=None) -> np.ndarray:
        """(H, W, 3) float32 overlay in the frame's y-up rows, over `base`
        (same rows) or black: the reference's visualize_accel palette (dim
        boxes of the level, white children, light blue triangle edges of
        the selection, its box orange)."""
        cam = self.camera
        img = (np.zeros((cam.screen_h, cam.screen_w, 3), np.float32)
               if base is None else np.array(base, np.float32))
        level, idx = self.selected
        rows = self.h.boxes(level)
        for i in range(rows.shape[0]):       # cnode .5, α .25
            if i != idx:
                self._draw_box(img, rows[i], (0.5, 0.5, 0.5), 0.25)
        nch = self.h.n_children(level, idx)
        if nch:                               # cnode_hl_child
            crows = self.h.boxes(level + 1)
            first = self.h.child_index(level, idx, 0)
            for j in range(first, first + nch):
                self._draw_box(img, crows[j], (1.0, 1.0, 1.0), 0.6)
        t0, t1 = self.h.tri_range(level, idx)  # cprim_hl_left .6, .6, 1
        step = max(1, (t1 - t0) // 512)        # bound the draw cost
        for t in range(t0, t1, step):
            if not self.h.live[t]:
                continue
            px, vis = self._project(self.h.tris[t])
            for i, j in ((0, 1), (1, 2), (2, 0)):
                if vis[i] and vis[j]:
                    self._line(img, px[i], px[j], (0.6, 0.6, 1.0), 1.0)
        # the selection, orange and thick (cnode_hl 1, .25, 0, α .8)
        self._draw_box(img, rows[idx], (1.0, 0.25, 0.0), 0.8, thick=3)
        return img

    def status(self) -> dict:
        level, idx = self.selected
        t0, t1 = self.h.tri_range(level, idx)
        return {"level": LEVELS[level], "index": int(idx),
                "tri_rows": [int(t0), int(t1)], "depth": len(self.stack)}
