"""Asset-free scenes.

The main path's two scenes are the lat/lon triangle soup of the reference's
``__graft_entry__._wide_bvh_scene``: a unit UV sphere cut into
``lat * lon`` quads, two triangles each, with per-vertex normals equal to
the positions. The real Dragon_80K mesh is not in the repository, so the
headline scene refines the same soup to 80,000 triangles under the dragon
bench's camera, material and ground sphere (reference ``bench.dragon_scene``).
It stays a convex sphere: a bounced ray never hits it again, which a
dragon's folds do, so its times do not stand for the dragon's.

The small-scene path renders the reference's asset-free built-in scenes
``balls``, ``metal``, ``random_balls`` and ``room``
(``ray_tracer_2_tpu/scene/scenes.py:58-153,211-224``), copied here
definition for definition. ``room2_scene`` is the reference's benchmark
scene ``room_2`` with the same soup standing in for its two dragons;
``instances_scene`` fills the frame with shared instances.
"""
from __future__ import annotations

import numpy as np

from ray_tracer_2_tpu_torch.math.transform import Transform, quat_rotate_y
from ray_tracer_2_tpu_torch.scene.camera import CameraDescriptor
from ray_tracer_2_tpu_torch.scene.definition import (
    MeshData, MeshFromData, SceneDefinition,
)
from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition


def _quad_mesh(verts, normal, indices) -> MeshFromData:
    verts = np.asarray(verts, np.float32)
    n = np.tile(np.asarray(normal, np.float32)[None, :], (len(verts), 1))
    data = MeshData.from_vertices(verts, n,
                                  indices=np.asarray(indices, np.uint32))
    return MeshFromData(data)


def balls() -> SceneDefinition:
    """scene.rs:802-863: six spheres, one of them emissive."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([3.089, 1.53, -3.0], [-2.0, -1.0, 2.0]),
        fov=45.0, near=0.1, far=100.0, focus_dist=0.1))
    new = MaterialDefinition.new
    s.add_sphere([-3.64, -0.42, 0.8028], 0.75,
                 new().specular_([1.0] * 4, 0.7).with_color([1.0, 1.0, 1.0, 1.0]))
    s.add_sphere([-2.54, -0.72, 0.5], 0.6,
                 new().with_color([1.0, 0.0, 0.0, 1.0]).specular_([1, 0, 0, 1], 0.5))
    s.add_sphere([-1.27, -0.72, 1.0], 0.5,
                 new().with_color([0.0, 1.0, 0.0, 1.0]).specular_([0, 1, 0, 1], 0.2))
    s.add_sphere([-0.5, -0.9, 1.55], 0.35, new().with_color([0.0, 0.0, 1.0, 1.0]))
    s.add_sphere([-3.46, -15.88, 2.76], 15.0, new().with_color([0.5, 0.0, 0.8, 1.0]))
    s.add_sphere([-7.44, -0.72, 20.0], 15.0,
                 new().with_color([0.1, 0.1, 0.1, 0.0]).emissive([1.0] * 4, 1.0))
    return s


def random_balls(seed: int = 42) -> SceneDefinition:
    """scene.rs:365-444 (the final scene of Ray Tracing in One Weekend): 4
    large spheres and ~480 small ones drawn from ``default_rng(seed)`` in
    the reference's order, so the layout is the reference's."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([13.0, 2.0, 3.0], [0.0, 0.0, 0.0]),
        fov=20.0, aspect=16.0 / 9.0, near=0.1, far=100.0, focus_dist=10.0))
    new = MaterialDefinition.new
    s.add_sphere([0.0, -1000.0, 0.0], 1000.0, new().with_color([0.5, 0.5, 0.5, 1.0]))
    s.add_sphere([0.0, 1.0, 0.0], 1.0, new().glass(1.5))
    s.add_sphere([-4.0, 1.0, 0.0], 1.0, new().with_color([0.4, 0.2, 0.1, 1.0]))
    s.add_sphere([4.0, 1.0, 0.0], 1.0,
                 new().with_color([0.7, 0.6, 0.5, 1.0])
                 .specular_([0.7, 0.6, 0.5, 1.0], 1.0).smooth(1.0))

    rng = np.random.default_rng(seed)
    for a in range(-11, 11):
        for b in range(-11, 11):
            mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()], np.float32)
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if mat < 0.8:
                albedo = [rng.random(), rng.random(), rng.random(), 1.0]
                s.add_sphere(center, 0.2, new().with_color(albedo))
            elif mat < 0.95:
                albedo = [rng.uniform(0.5, 1.0), rng.uniform(0.5, 1.0),
                          rng.uniform(0.5, 1.0), 1.0]
                fuzz = rng.uniform(0.0, 0.5)
                s.add_sphere(center, 0.2,
                             new().with_color(albedo).specular_([1.0] * 4, fuzz))
            else:
                s.add_sphere(center, 0.2, new().glass(1.3))
    return s


def room() -> SceneDefinition:
    """scene.rs:445-573: a closed box of 12 triangles with an emissive
    ceiling quad, a glass sphere and a specular one."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 1.0, 3.0], [0.0, 1.0, 2.0]),
        fov=45.0, near=0.1, far=100.0, focus_dist=0.1))
    new = MaterialDefinition.new
    t = Transform()
    s.add_mesh(t, _quad_mesh([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]],
                             [0, 1, 0], [2, 1, 0, 3, 2, 0]),
               new().with_color([1.0, 0.0, 0.0, 1.0]))
    s.add_mesh(t, _quad_mesh([[-2, 4, -2], [2, 4, -2], [2, 4, 2], [-2, 4, 2]],
                             [0, -1, 0], [0, 1, 2, 0, 2, 3]),
               new().with_color([0.0, 0.3, 0.3, 1.0]))
    s.add_mesh(t, _quad_mesh([[-2, 0, -2], [-2, 4, -2], [-2, 4, 2], [-2, 0, 2]],
                             [1, 0, 0], [0, 1, 2, 0, 2, 3]),
               new().specular_([1.0] * 4, 1.0).smooth(1.0))
    s.add_mesh(t, _quad_mesh([[2, 0, -2], [2, 0, 2], [2, 4, 2], [2, 4, -2]],
                             [-1, 0, 0], [0, 1, 2, 0, 2, 3]),
               new().specular_([1.0] * 4, 0.99).smooth(0.99))
    s.add_mesh(t, _quad_mesh([[-2, 0, 2], [2, 0, 2], [2, 4, 2], [-2, 4, 2]],
                             [0, 0, -1], [2, 1, 0, 3, 2, 0]),
               new().with_color([0.2, 0.2, 0.82, 1.0])
               .specular_([1.0] * 4, 0.99).smooth(0.99))
    s.add_mesh(t, _quad_mesh([[-0.4, 3.98, -0.4], [0.4, 3.98, -0.4],
                              [0.4, 3.98, 0.4], [-0.4, 3.98, 0.4]],
                             [0, -1, 0], [0, 1, 2, 0, 2, 3]),
               new().emissive([1.0] * 4, 3.0))
    s.add_sphere([0.4, 1.0, 0.0], 0.3,
                 new().with_color([0.4, 0.9, 0.4, 1.0]).glass(1.34))
    s.add_sphere([-0.4, 1.0, 0.0], 0.4,
                 new().with_color([0.7, 0.7, 0.7, 1.0]).specular_([1.0] * 4, 0.2))
    return s


def metal() -> SceneDefinition:
    """scene.rs:758-801: ground, diffuse, glass and metal spheres."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 0.0, 3.0], [0.0, 0.0, -1.0]),
        fov=45.0, near=0.1, far=100.0, focus_dist=0.1))
    new = MaterialDefinition.new
    s.add_sphere([0.0, -100.5, -1.0], 100.0, new().with_color([0.8, 0.8, 0.0, 1.0]))
    s.add_sphere([0.0, 0.0, -1.0], 0.5, new().with_color([0.7, 0.3, 0.3, 1.0]))
    s.add_sphere([-1.0, 0.0, -1.0], 0.5,
                 new().with_color([0.8, 0.8, 0.8, 1.0]).glass(1.3))
    s.add_sphere([1.0, 0.0, -1.0], 0.5,
                 new().with_color([0.8, 0.6, 0.2, 1.0]).specular_([1.0] * 4, 0.15))
    return s


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


ROOM2_RADIUS = 0.25
"""Model-space radius of room2's stand-in soup. Under the first dragon's
transform (scale 4.7 about y = 1.2, z = -0.6) it is a sphere of radius
about 1.18 that sits inside the inner room, above its floor at y = 0 and
before its back wall at z = -2; the second, unscaled one floats above the
ceiling. Chosen, not taken from the dragon."""


def room2_scene(lat: int = 200, lon: int = 200) -> SceneDefinition:
    """The reference's benchmark scene ``room_2``
    (``ray_tracer_2_tpu/scene/scenes.py:156-208``; scene.rs:574-757):
    camera with depth of field, materials, transforms, eight quads (one
    identity-transform group of 16 triangles, a 60-strength light among
    them) and a glass sphere, word for word. The one change: both dragons
    are one shared ``latlon_soup(lat, lon, ROOM2_RADIUS)`` (80,000
    triangles at the default size), so the two instances share tables as
    the reference's two loads of one OBJ do."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 1.28, 13.5], [0.0, 1.28, 12.5]),
        fov=26.0, near=0.1, far=100.0, focus_dist=8.6,
        defocus_strength=100.0, diverge_strength=1.5))
    new = MaterialDefinition.new
    width, depth, height = 3.0, 2.0, 4.0
    dragon_mat = (new().with_color([0.96078, 0.11372, 0.4039, 1.0])
                  .smooth(0.8).specular_([1.0] * 4, 0.015))
    dragon = MeshFromData(latlon_soup(lat, lon, ROOM2_RADIUS))
    s.add_mesh(Transform(pos=[0.0, 1.2, -0.6], rot=quat_rotate_y(-1.5708),
                         scale=[4.7, 4.7, 4.7]), dragon, dragon_mat)
    s.add_mesh(Transform(pos=[0.0, 7.2, 2.0], rot=quat_rotate_y(-1.5708)),
               dragon, dragon_mat)
    t = Transform()
    s.add_mesh(t, _quad_mesh([[-10, -0.01, -10], [10, -0.01, -10],
                              [10, -0.01, 10], [-10, -0.01, 10]],
                             [0, 1, 0], [2, 1, 0, 3, 2, 0]),
               new().with_color([0.4, 0.4, 0.64313, 1.0]))
    s.add_mesh(t, _quad_mesh([[-10, 8.5, -10], [10, 8.5, -10],
                              [10, 8.5, 10], [-10, 8.5, 10]],
                             [0, -1, 0], [0, 1, 2, 0, 2, 3]),
               new().with_color([0.898, 0.87, 0.815, 1.0])
               .smooth(0.877).specular_([1.0] * 4, 0.327))
    s.add_mesh(t, _quad_mesh([[-width, 0, -depth], [width, 0, -depth],
                              [width, 0, depth], [-width, 0, depth]],
                             [0, 1, 0], [2, 1, 0, 3, 2, 0]),
               new().with_color([0.898, 0.87, 0.815, 1.0]))
    s.add_mesh(t, _quad_mesh([[-width, height, -depth], [width, height, -depth],
                              [width, height, depth], [-width, height, depth]],
                             [0, -1, 0], [0, 1, 2, 0, 2, 3]),
               new().with_color([1.0, 0.9647, 0.9019, 1.0]))
    s.add_mesh(t, _quad_mesh([[-width, 0, -depth], [-width, height, -depth],
                              [-width, height, depth], [-width, 0, depth]],
                             [1, 0, 0], [0, 1, 2, 0, 2, 3]),
               new().with_color([0.0705, 0.596, 0.2078, 1.0]))
    s.add_mesh(t, _quad_mesh([[width, 0, -depth], [width, 0, depth],
                              [width, height, depth], [width, height, -depth]],
                             [-1, 0, 0], [0, 1, 2, 0, 2, 3]),
               new().with_color([0.7725, 0.12156, 0.188235, 1.0]))
    s.add_mesh(t, _quad_mesh([[-width, 0, -depth], [width, 0, -depth],
                              [width, height, -depth], [-width, height, -depth]],
                             [0, 0, 1], [0, 1, 2, 0, 2, 3]),
               new().with_color([0.1254, 0.41176, 0.8274, 1.0]))
    s.add_mesh(t, _quad_mesh([[-0.8, height - 0.02, -0.8],
                              [0.8, height - 0.02, -0.8],
                              [0.8, height - 0.02, 0.8],
                              [-0.8, height - 0.02, 0.8]],
                             [0, -1, 0], [0, 1, 2, 0, 2, 3]),
               new().emissive([1.0, 0.8588, 0.3529, 1.0], 60.0))
    s.add_sphere([0.0, 1.0, 4.4], 1.15,
                 new().specular_([1.0] * 4, 0.517).smooth(1.0).glass(1.6))
    return s


def instances_scene() -> SceneDefinition:
    """Four instances on a ground sphere: two shared soups under two
    transforms and two materials each, a 300-triangle one (traversed in its
    wide BVH) and a 72-triangle one (brute force). Every hit's material
    needs its instance's delta and its normal its instance's transform. At
    128x72, 38% of the primary rays end on an instance (16%, 7%, 10% and 4%
    in instance order), 28% on the ground and 34% in the sky."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 0.8, 2.6], [0.0, 0.55, 0.0]),
        fov=40.0, focus_dist=4.0))
    new = MaterialDefinition.new
    big = MeshFromData(latlon_soup(10, 15, 0.5))
    small = MeshFromData(latlon_soup(4, 9, 0.4))
    for x, rot, mat in ((-1.2, 0.3, new().with_color([0.8, 0.3, 0.2, 1.0])),
                        (0.2, -0.9, new().with_color([0.2, 0.7, 0.3, 1.0])
                         .specular_([1.0] * 4, 0.5).smooth(0.8))):
        s.add_mesh(Transform(pos=[x, 0.5, 0.0], rot=quat_rotate_y(rot),
                             scale=[1.0, 1.4, 1.0]), big, mat)
        s.add_mesh(Transform(pos=[x + 1.1, 0.4, 0.6],
                             rot=quat_rotate_y(-rot), scale=[0.8] * 3),
                   small, mat.emissive([1.0, 0.9, 0.6, 1.0], 2.0))
    s.add_sphere([0.0, -100.0, 0.0], 100.0,
                 new().with_color([0.5, 0.5, 0.5, 1.0]))
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
