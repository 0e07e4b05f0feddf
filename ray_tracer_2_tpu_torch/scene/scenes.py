"""Asset-free scenes of the main path.

Both are the lat/lon triangle soup of the reference's
``__graft_entry__._wide_bvh_scene``: a unit UV sphere cut into
``lat * lon`` quads, two triangles each, with per-vertex normals equal to
the positions. The real Dragon_80K mesh is not in the repository, so the
headline scene refines the same soup to 80,000 triangles under the dragon
bench's camera, material and ground sphere (reference ``bench.dragon_scene``).
It stays a convex sphere: a bounced ray never hits it again, which a
dragon's folds do, so its times do not stand for the dragon's.
"""
from __future__ import annotations

import numpy as np

from ray_tracer_2_tpu_torch.math.transform import Transform, quat_rotate_y
from ray_tracer_2_tpu_torch.scene.camera import CameraDescriptor
from ray_tracer_2_tpu_torch.scene.definition import (
    MeshData, MeshFromData, SceneDefinition,
)
from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition


def latlon_soup(lat: int, lon: int, radius: float = 1.0) -> MeshData:
    """UV-sphere triangle soup of ``radius`` about the origin,
    ``2 * lat * lon`` triangles, with unit normals."""
    th = np.linspace(0.0, np.pi, lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, lon + 1)
    p = np.stack(np.meshgrid(th, ph, indexing="ij"), axis=-1)
    xyz = np.stack([np.sin(p[..., 0]) * np.cos(p[..., 1]),
                    np.cos(p[..., 0]),
                    np.sin(p[..., 0]) * np.sin(p[..., 1])], axis=-1)
    a, b = xyz[:-1, :-1], xyz[1:, :-1]
    c, d = xyz[1:, 1:], xyz[:-1, 1:]
    quads = np.stack([np.stack([a, b, c], axis=-2),
                      np.stack([a, c, d], axis=-2)], axis=-3)
    soup = quads.reshape(-1, 3).astype(np.float32)
    return MeshData.from_vertices(soup * np.float32(radius), soup)


def wide_bvh_scene(lat: int = 22, lon: int = 34) -> SceneDefinition:
    """The reference's ``_wide_bvh_scene`` (1,496 triangles at the default
    size): one wide-BVH instance plus one small sphere."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 0.6, 3.2], [0.0, 0.5, 0.0]),
        fov=42.0, focus_dist=3.2))
    s.add_mesh(Transform(pos=[0.0, 0.5, 0.0], rot=quat_rotate_y(0.7),
                         scale=[0.9, 0.9, 0.9]),
               MeshFromData(latlon_soup(lat, lon)),
               MaterialDefinition.new().with_color([0.8, 0.3, 0.2, 1.0])
               .smooth(0.4).specular_([1.0] * 4, 0.1))
    s.add_sphere([1.1, 0.35, 0.6], 0.35,
                 MaterialDefinition.new().with_color([0.4, 0.9, 0.4, 1.0]))
    return s


MAIN_PATH_RADIUS = 0.3
"""Model-space radius of the headline soup. Under the dragon's transform
(scale 3 about y = 0.6) it is a sphere of radius 0.9 sunk 0.3 into the
ground; the camera sees about 13 degrees of its radius against a 20-degree
half field of view, so the frame holds sky, ground and a silhouette. The
dragon's own extent is not in the repository; this one is chosen, not
taken from it."""


def main_path_scene(lat: int = 200, lon: int = 200) -> SceneDefinition:
    """The headline scene: the soup at 80,000 triangles (default size) in
    place of Dragon_80K, with the dragon bench's camera, transform,
    material and ground sphere (reference ``bench.dragon_scene``)."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 1.0, 4.0], [0.0, 0.7, 0.0]),
        fov=40.0, focus_dist=4.0))
    s.add_mesh(Transform(pos=[0.0, 0.6, 0.0], rot=quat_rotate_y(-1.5708),
                         scale=[3.0, 3.0, 3.0]),
               MeshFromData(latlon_soup(lat, lon, MAIN_PATH_RADIUS)),
               MaterialDefinition.new()
               .with_color([0.96078, 0.11372, 0.4039, 1.0])
               .smooth(0.8).specular_([1.0] * 4, 0.015))
    s.add_sphere([0.0, -1000.0, 0.0], 1000.0,
                 MaterialDefinition.new().with_color([0.5, 0.5, 0.5, 1.0]))
    return s
