"""Edge cases of the brute-force closest hit, as data.

One list, ``edge_cases()``, that the CPU tests hold the plain version to
(against the JAX package and a numpy model), and that the card tests and
``chip_smoke.py`` hold the CUDA kernel to (against the plain version): the
kernel meets exactly the cases the plain version is pinned on. Everything
is made with numpy from fixed seeds.

A case is a triangle table (vertices, a material id per triangle, which
material ids are glass, i.e. two-sided) and rays. ``knife_edge`` marks the
cases whose rays sit on a threshold in general position (aimed at an edge
or a vertex computed in float32): there the sign of a barycentric of the
order of 1e-8 decides, so an implementation that contracts ``a * b + c``
into a fused multiply-add may decide otherwise; the other cases sit on
their thresholds in numbers that every product represents exactly (the
unit triangle, axis-aligned rays), where contraction changes nothing.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

#: material ids of the cases' tables: 0 and 2 are diffuse (backfaces
#: culled), 1 and 3 glass (two-sided)
N_MATERIALS = 4
GLASS_IDS = (1, 3)
#: table sizes around the kernels' 16-triangle groups, the 256-triangle
#: staged chunk and the 600-triangle three-chunk table
SIZES = (1, 15, 16, 17, 255, 256, 257, 600)


@dataclasses.dataclass(frozen=True)
class BruteCase:
    name: str
    v0: np.ndarray          # (T, 3) float32
    v1: np.ndarray
    v2: np.ndarray
    mat: np.ndarray         # (T,) int32 in [0, N_MATERIALS)
    origin: np.ndarray      # (B, 3) float32
    direction: np.ndarray   # (B, 3) float32
    knife_edge: bool = False
    #: the least number of rays that must hit (the case is not vacuous)
    min_hits: int = 1

    @property
    def count(self) -> int:
        return self.v0.shape[0]


def table_scene(case: BruteCase, device="cpu"):
    """What ``brute_force_intersect``, its plain version and
    ``pack_brute_table`` read of a scene, for the case's table: vertices,
    material ids, material rows (column 21 the flag), ``derived``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    rows = np.zeros((N_MATERIALS, 32), np.float32)
    rows[list(GLASS_IDS), 21] = 1.0     # MaterialFlag.GLASS
    return types.SimpleNamespace(
        tri_v0=t(case.v0), tri_v1=t(case.v1), tri_v2=t(case.v2),
        tri_mat=t(case.mat.astype(np.int32)), mat_rows=t(rows), derived={},
        device=torch.device(device))


def _f32(*rows) -> np.ndarray:
    return np.asarray(rows, np.float32).reshape(-1, 3)


def _unit(n: int, z: float = 0.0, flip: bool = False):
    """``n`` copies of the unit triangle (0,0,z) (1,0,z) (0,1,z); its normal
    is +z, or -z with ``flip`` (v1 and v2 swapped)."""
    v0 = np.tile(_f32([0, 0, z]), (n, 1))
    v1 = np.tile(_f32([1, 0, z]), (n, 1))
    v2 = np.tile(_f32([0, 1, z]), (n, 1))
    return (v0, v2, v1) if flip else (v0, v1, v2)


def _down(points, z: float = 1.0):
    """Rays from (x, y, z) straight down -z."""
    o = np.asarray([[x, y, z] for x, y in points], np.float32)
    return o, np.tile(_f32([0, 0, -1]), (len(points), 1))


def _case(name, tris, mat, rays, **kw) -> BruteCase:
    v0, v1, v2 = (np.ascontiguousarray(a, np.float32) for a in tris)
    o, d = rays
    return BruteCase(name, v0, v1, v2, np.asarray(mat, np.int32),
                     np.ascontiguousarray(o, np.float32),
                     np.ascontiguousarray(d, np.float32), **kw)


def _stack(*tables):
    return tuple(np.concatenate([t[i] for t in tables]) for i in range(3))


def _soup(rng, n: int):
    """``n`` random triangles in a 2-unit box with materials of all four
    ids, and 96 rays, each aimed at the inside of a triangle from 0.5 to 2
    units off its plane on either side, within 0.2 units of its normal
    (so most hit something, front or back, and none grazes its target)."""
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    mat = rng.integers(0, N_MATERIALS, n).astype(np.int32)
    B = 96
    k = rng.integers(0, n, B)
    a, b = rng.uniform(0.1, 0.4, (2, B, 1)).astype(np.float32)
    target = v0[k] + a * e1[k] + b * e2[k]
    normal = np.cross(e1[k], e2[k])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    side = rng.choice([-1.0, 1.0], (B, 1)) * rng.uniform(0.5, 2.0, (B, 1))
    o = (target + side * normal
         + rng.uniform(-0.2, 0.2, (B, 3))).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (v0, v0 + e1, v0 + e2), mat, (o, d)


def _on_edges(rng, n: int):
    """A soup whose rays are aimed at points on an edge or at a vertex of a
    triangle, the points computed in float32: general-position knife
    edges."""
    tris, mat, (o, _) = _soup(rng, n)
    v0, v1, v2 = tris
    B = o.shape[0]
    k = rng.integers(0, n, B)
    s = rng.uniform(0, 1, (B, 1)).astype(np.float32)
    ends = np.stack([v0[k], v1[k], v2[k]])                 # (3, B, 3)
    e = rng.integers(0, 3, B)
    p, q = ends[e, np.arange(B)], ends[(e + 1) % 3, np.arange(B)]
    s[: B // 4] = 0.0                                      # a vertex
    target = p + s * (q - p)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return tris, mat, (o, d)


def edge_cases() -> list:
    """The cases, in a fixed order (see the module docstring)."""
    eps = np.float32(1e-5)
    above = np.nextafter(eps, np.float32(1))
    inside = [(0.25, 0.25), (0.5, 0.25), (0.125, 0.625)]
    cases = [
        # five copies of one triangle before and after another one nearer
        # the ray: the lowest index of the nearest distance wins
        _case("duplicates", _stack(_unit(3, 0.0), _unit(4, 0.5), _unit(2, 0.0),
                                   _unit(3, 0.5)),
              [0, 2, 0, 2, 0, 2, 0, 2, 0, 2, 0, 2], _down(inside, 2.0),
              min_hits=3),
        # zero-area triangles (two equal vertices; three collinear ones):
        # det = 0, never a hit; the unit triangle behind them is
        _case("degenerate",
              _stack((_f32([0, 0, .5], [0, 0, .5]), _f32([0, 0, .5], [.5, .5, .5]),
                      _f32([1, 1, .5], [1, 1, .5])), _unit(1, 0.0)),
              [0, 1, 2], _down(inside), min_hits=3),
        # rays in the plane of a triangle or parallel to it (det = 0): no
        # hit on it, with either cull flag
        _case("parallel", _stack(_unit(1, 0.0), _unit(1, 0.5)), [0, 1],
              (_f32([-1, .25, 0], [-1, .25, .5], [-1, .25, .25], [.25, .25, 1]),
               _f32([1, 0, 0], [1, 0, 0], [1, 0, 0], [0, 0, -1])),
              min_hits=1),
        # origins on the plane and EPSILON above it: dst = 0 and dst = 1e-5
        # are no hits (dst > EPSILON), the next float32 above is
        _case("origin_on_plane", _stack(_unit(1, 0.0), _unit(1, -1.0)), [0, 2],
              (_f32([.25, .25, 0], [.25, .25, eps], [.25, .25, above],
                    [.25, .25, 1]),
               np.tile(_f32([0, 0, -1]), (4, 1))), min_hits=4),
        # exactly on an edge (u, v or w = 0; v = -0.0 on the first), on
        # each vertex, and just outside
        _case("edges_and_vertices", _unit(1, 0.0), [0],
              _down([(.5, 0), (0, .5), (.5, .5), (0, 0), (1, 0), (0, 1),
                     (.5, -1e-6), (-1e-6, .5), (.5 + 1e-6, .5)]),
              min_hits=6),
        # triangles facing away from the ray: culled rows let it through
        # to the triangle behind, two-sided (glass) rows are hit (det < 0)
        _case("facing_away", _stack(_unit(1, 0.5, flip=True),
                                    _unit(1, 0.25, flip=True), _unit(1, 0.0)),
              [0, 1, 2], _down(inside), min_hits=3),
        _case("facing_away_all_culled", _stack(_unit(2, 0.5, flip=True)),
              [0, 2], _down(inside), min_hits=0),
    ]
    for i, n in enumerate(SIZES):
        tris, mat, rays = _soup(np.random.default_rng(100 + i), n)
        cases.append(_case(f"soup_{n}", tris, mat, rays,
                           min_hits=8 if n > 1 else 1))
    for i, n in enumerate((16, 257)):
        tris, mat, rays = _on_edges(np.random.default_rng(200 + i), n)
        cases.append(_case(f"on_edges_{n}", tris, mat, rays, knife_edge=True,
                           min_hits=8))
    return cases
