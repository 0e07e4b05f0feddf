"""The scene as the reference reads it, worked out again from the
configuration's inputs (triangles, materials, transforms, spheres, images):
instances grouped by transform, each with its model-space triangles and a
box tree of its own over them, the material table, the texture bytes.
Nothing here is taken from the program."""
from __future__ import annotations

import json
import warnings

import numpy as np
import torch

from rtbench.reference.camera import transform_matrix

#: triangles a leaf box holds, and boxes a tree node holds
LEAF = 16
FAN = 8
#: a group of at most this many triangles is tested before the others
#: (the renderer's brute-force groups, merged first on equal distance)
SMALL_GROUP = 256
#: spheres from which the program's dense test is reassociated: a copy of
#: ``ray_tracer_2_tpu_torch/kernels/intersect.py:SPHERE_FAST_MIN``, held
#: equal to it by ``tests/test_rtbench_glass.py``
SPHERE_FAST_MIN = 64

#: a material's keys, as the program's ``MaterialDefinition`` names them,
#: with its defaults; ``texture`` is its diffuse texture, an image's name
_MAT_DEFAULTS = dict(color=(0.7, 0.7, 0.7, 1.0),
                     emission_color=(0.0, 0.0, 0.0, 0.0),
                     specular_color=(1.0, 1.0, 1.0, 1.0),
                     absorption=(0.0, 0.0, 0.0, 0.0),
                     absorption_strength=0.0, emission_strength=0.0,
                     smoothness=1.0, specular=0.0, ior=1.0, flag=0,
                     texture=None)
#: the material flags the reference follows (upstream material.rs:38-43):
#: default, glass, textured. A named texture makes a material textured
#: whatever its flag, as the program resolves it, so a textured glass
#: material is shaded as a textured one
FLAG_DEFAULT, FLAG_GLASS, FLAG_TEXTURE = 0, 1, 2


def _is_glass(m: dict) -> bool:
    return m["flag"] == FLAG_GLASS and m["texture"] is None


def material(m: dict, images: dict) -> dict:
    """A configuration's material with the defaults filled in. Raises on a
    key, a flag or a texture the reference does not follow, so that no
    part of a material is ignored without a word."""
    other = set(m) - set(_MAT_DEFAULTS)
    if other:
        raise ValueError(f"the reference does not follow the material "
                         f"keys {sorted(other)}")
    full = dict(_MAT_DEFAULTS, **m)
    if full["flag"] not in (FLAG_DEFAULT, FLAG_GLASS, FLAG_TEXTURE):
        raise ValueError(f"the reference does not follow the material "
                         f"flag {full['flag']!r}")
    if full["texture"] is not None and full["texture"] not in images:
        raise ValueError(f"no image {full['texture']!r} for a material")
    return full


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points ``c`` (n, 3) in their bounding box."""
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-30) * 1023.0).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def box_tree(v0, v1, v2):
    """A tree of boxes over triangles (model space): triangles sorted by
    the Morton code of their centroids, ``LEAF`` to a leaf box, ``FAN``
    boxes to a node, up to a root level of at most ``FAN`` boxes. Returns
    (the triangles in tree order, padded with -1 to ``LEAF`` a leaf; the
    levels, root first, each (lo, hi) float32 (n, 3), every level but the
    root ``FAN`` times as long as the one above). Boxes are padded outward,
    so that a float32 slab test never misses a triangle that the exact test
    hits; a box with nothing under it is NaN, which no slab test hits."""
    n = max(-(-len(v0) // LEAF), 1)
    depth = 0
    while FAN ** (depth + 1) < n:
        depth += 1
    # level sizes, leaves first: m FAN^depth, ..., m with m <= FAN
    m = -(-n // FAN ** depth)
    sizes = [m * FAN ** k for k in range(depth, -1, -1)]
    order = np.argsort(_morton((v0 + v1 + v2) / 3.0), kind="stable") \
        if len(v0) else np.zeros(0, np.int64)
    order = np.concatenate([order, -np.ones(sizes[0] * LEAF - len(order),
                                            np.int64)])
    corners = np.stack([v0, v1, v2], axis=1).astype(np.float64)
    idx = order.reshape(sizes[0], LEAF)
    valid = (idx >= 0)[..., None, None]
    pts = np.where(valid, corners[np.where(idx >= 0, idx, 0)], np.nan)
    extent = float(np.abs(corners).max()) if len(corners) else 1.0
    slack = 1e-5 * extent + 1e-7
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # all-NaN boxes
        lo = np.nanmin(pts, axis=(1, 2)) - slack
        hi = np.nanmax(pts, axis=(1, 2)) + slack
        levels = [(lo, hi)]
        for n in sizes[1:]:
            lo, hi = levels[0]
            levels.insert(0, (np.nanmin(lo.reshape(n, FAN, 3), axis=1),
                              np.nanmax(hi.reshape(n, FAN, 3), axis=1)))
    return order, [(a.astype(np.float32), b.astype(np.float32))
                   for a, b in levels]


class RefScene:
    """The configuration's scene on ``device`` in ``dtype`` (float32, or a
    lower precision for the control)."""

    def __init__(self, inputs: dict, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=self.device).to(dtype)
        mats, mat_ids = [], {}
        images = inputs.get("images", {})

        def mat_index(m: dict) -> int:
            full = material(m, images)
            key = json.dumps(full, sort_keys=True)
            if key not in mat_ids:
                mat_ids[key] = len(mats)
                mats.append(full)
            return mat_ids[key]

        # instances: meshes of one transform make one, in order of first
        # appearance; small ones are merged first
        groups: dict[str, dict] = {}
        for mesh in inputs["meshes"]:
            key = json.dumps(mesh["transform"], sort_keys=True)
            g = groups.setdefault(key, dict(transform=mesh["transform"],
                                            parts=[]))
            g["parts"].append((mesh, mat_index(mesh["material"])))
        ordered = list(groups.values())
        ordered = [g for g in ordered if self._count(g) <= SMALL_GROUP] + \
            [g for g in ordered if self._count(g) > SMALL_GROUP]
        self.instances = [self._instance(g, f, mats) for g in ordered]

        sph = inputs["spheres"]
        self.sphere_pos = f([s["centre"] for s in sph]).reshape(-1, 3)
        self.sphere_radius = f([s["radius"] for s in sph]).reshape(-1)
        # the quadratic in float64 where the program's test is
        # reassociated (``tracer``'s docstring)
        self.sphere_dtype = torch.float64 \
            if dtype == torch.float32 and len(sph) >= SPHERE_FAST_MIN \
            else dtype
        self.sphere_mat = torch.tensor([mat_index(s["material"]) for s in sph],
                                       dtype=torch.int64, device=self.device)

        names = list(images)
        self.mat_color = f([m["color"] for m in mats])
        self.mat_emit = f([m["emission_color"] for m in mats]) * \
            f([m["emission_strength"] for m in mats])[:, None]
        self.mat_spec_color = f([m["specular_color"] for m in mats])
        self.mat_smooth = f([m["smoothness"] for m in mats])
        self.mat_specular = f([m["specular"] for m in mats])
        self.mat_slot = torch.tensor(
            [names.index(m["texture"]) if m["texture"] is not None else -1
             for m in mats], dtype=torch.int64, device=self.device)
        self.image_list = [torch.as_tensor(np.ascontiguousarray(images[n]),
                                           device=self.device) for n in names]
        glass = [_is_glass(m) for m in mats]
        self.has_glass = any(glass)
        self.mat_glass = torch.tensor(glass, dtype=torch.bool,
                                      device=self.device)
        self.mat_ior = f([m["ior"] for m in mats])
        self.mat_absorb = f([m["absorption"][:3] for m in mats])
        self.mat_absorb_k = f([m["absorption_strength"] for m in mats])

    @staticmethod
    def _count(g) -> int:
        return sum(len(mesh["pos"]) // 3 for mesh, _ in g["parts"])

    def _instance(self, g: dict, f, mats: list) -> dict:
        dev = self.device
        m2w = transform_matrix(g["transform"])
        w2m = np.linalg.inv(m2w.astype(np.float64)).astype(np.float32)
        cat = lambda k: np.concatenate(
            [np.asarray(mesh[k], np.float32) for mesh, _ in g["parts"]])
        pos, nrm, uv = cat("pos"), cat("nrm"), cat("uv")
        mat = np.concatenate([np.full(len(mesh["pos"]) // 3, mid, np.int64)
                              for mesh, mid in g["parts"]])
        v0, v1, v2 = pos[0::3], pos[1::3], pos[2::3]
        e1 = (v1 - v0).astype(np.float32)
        e2 = (v2 - v0).astype(np.float32)
        n = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                      e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                      e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=1)
        order, levels = box_tree(v0, v1, v2)
        ordered = np.where(order >= 0, order, 0)
        # one row of geometry a triangle in tree order: v0, e1, e2, n;
        # padding slots have n = 0, which no test keeps
        geo = np.concatenate([v0, e1, e2, n], axis=1)[ordered]
        geo[order < 0] = 0.0
        # glass triangles are tested two-sided (the program's cull flag,
        # 1 unless glass); None where the instance has none
        glass = np.array([_is_glass(m) for m in mats])[mat][ordered] \
            & (order >= 0)
        two_sided = torch.as_tensor(glass.reshape(-1, LEAF), device=dev) \
            if glass.any() else None
        return dict(
            two_sided=two_sided,
            m2w=f(m2w), w2m=f(w2m),
            geo=f(geo).reshape(-1, LEAF, 12),
            tri=torch.as_tensor(order, device=dev),
            nrm=f(np.stack([nrm[0::3], nrm[1::3], nrm[2::3]], axis=1)),
            uv=f(np.stack([uv[0::3], uv[1::3], uv[2::3]], axis=1)),
            mat=torch.as_tensor(mat, device=dev),
            levels=[(f(lo), f(hi)) for lo, hi in levels])
