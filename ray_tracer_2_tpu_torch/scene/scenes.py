"""Built-in scenes (port of ``ray_tracer_2_tpu/scene/scenes.py``) and the
port's asset-free stand-ins.

The reference's scene table is here definition for definition: ``balls``,
``random_balls``, ``room``, ``room_2``, ``metal``, ``sponza``,
``cornell_box``, ``texture_test``, ``obj_test`` and ``bugatti``, with
``SceneName`` and ``build_scene_definition``. Those that name a file
resolve it through the asset manager (``assets/manager.py``) when it is
instantiated: ``sponza.obj`` and ``f1/f1.obj`` fall back to the procedural
substitutes (``assets/procedural.py``), so ``sponza`` and ``bugatti``
render without a file; ``room_2`` (``Dragon_80K.obj``, built from
``dragon.obj``), ``cornell_box``, ``texture_test`` (``earthmap.png``) and
``obj_test`` raise ``AssetNotFound`` until their files are in a search
directory, as in the reference.

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
``instances_scene`` fills the frame with shared instances;
``random_balls(half=24)`` (about 2,300 spheres, enough for the sphere BVH)
and ``groups_scene`` (brute-force tables past the megakernel's
shared-memory budget) are stand-ins for tests and measurement.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from ray_tracer_2_tpu_torch.math.transform import (
    Transform, quat_rotate_x, quat_rotate_y,
)
from ray_tracer_2_tpu_torch.scene.camera import CameraDescriptor
from ray_tracer_2_tpu_torch.scene.definition import (
    MeshData, MeshFromData, MeshFromFile, SceneDefinition,
)
from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition, \
    MaterialFlag


class SceneName(enum.Enum):
    """scene.rs:34-68."""

    BALLS = "Balls"
    RANDOM_BALLS = "RandomBalls"
    ROOM = "Room"
    ROOM2 = "Room2"
    METAL = "Metal"
    SPONZA = "Sponza"
    CORNELL_BOX = "CornellBox"
    EMPTY = "Empty"

    def next(self) -> "SceneName":
        cycle = [SceneName.BALLS, SceneName.RANDOM_BALLS, SceneName.ROOM,
                 SceneName.ROOM2, SceneName.METAL, SceneName.SPONZA,
                 SceneName.CORNELL_BOX]
        if self not in cycle:
            return self
        return cycle[(cycle.index(self) + 1) % len(cycle)]

    @classmethod
    def all(cls) -> list["SceneName"]:
        """The 7 selectable scenes (scene.rs:59-67)."""
        return [cls.BALLS, cls.RANDOM_BALLS, cls.ROOM, cls.ROOM2, cls.METAL,
                cls.SPONZA, cls.CORNELL_BOX]


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


def random_balls(seed: int = 42, half: int = 11) -> SceneDefinition:
    """scene.rs:365-444 (the final scene of Ray Tracing in One Weekend): 4
    large spheres and ~480 small ones drawn from ``default_rng(seed)`` in
    the reference's order, so the layout is the reference's. The small
    spheres fill the cells of ``range(-half, half)`` squared: the default is
    the reference's scene, ``half=24`` the same recipe with about 2,300
    spheres."""
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
    for a in range(-half, half):
        for b in range(-half, half):
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


def sunlit_balls() -> SceneDefinition:
    """``random_balls`` under a spherical sun above the field (not a scene
    of the reference): a sphere light among hundreds of spheres, so that
    next-event estimation's cone sampling runs through the dense sphere
    loop or, instantiated with ``sphere_bvh=True``, through the sphere
    BVH."""
    s = random_balls()
    s.add_sphere([-20.0, 40.0, -30.0], 10.0, MaterialDefinition.new()
                 .with_color([0.1, 0.1, 0.1, 0.0])
                 .emissive([1.0, 0.95, 0.85, 1.0], 4.0))
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


def room_2() -> SceneDefinition:
    """scene.rs:574-757 ("infinite room": two dragons, DoF, warm area light),
    the reference's definition: both dragons are ``Dragon_80K.obj`` (see
    ``room2_scene`` for the asset-free stand-in)."""
    return _room2(MeshFromFile("Dragon_80K.obj", use_mtl=False),
                  MeshFromFile("Dragon_80K.obj", use_mtl=False))


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


def _room2(first, second) -> SceneDefinition:
    """room_2 (scene.rs:574-757) with ``first`` and ``second`` as its two
    dragons: camera, dragon material and transforms, eight quads and the
    glass sphere."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 1.28, 13.5], [0.0, 1.28, 12.5]),
        fov=26.0, near=0.1, far=100.0, focus_dist=8.6,
        defocus_strength=100.0, diverge_strength=1.5))
    new = MaterialDefinition.new
    width, depth, height = 3.0, 2.0, 4.0
    dragon_mat = (new().with_color([0.96078, 0.11372, 0.4039, 1.0])
                  .smooth(0.8).specular_([1.0] * 4, 0.015))
    s.add_mesh(Transform(pos=[0.0, 1.2, -0.6], rot=quat_rotate_y(-1.5708),
                         scale=[4.7, 4.7, 4.7]), first, dragon_mat)
    s.add_mesh(Transform(pos=[0.0, 7.2, 2.0], rot=quat_rotate_y(-1.5708)),
               second, dragon_mat)
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


def room2_scene(lat: int = 200, lon: int = 200) -> SceneDefinition:
    """The reference's benchmark scene ``room_2``
    (``ray_tracer_2_tpu/scene/scenes.py:156-208``; scene.rs:574-757):
    camera with depth of field, materials, transforms, eight quads (one
    identity-transform group of 16 triangles, a 60-strength light among
    them) and a glass sphere, word for word. The one change: both dragons
    are one shared ``latlon_soup(lat, lon, ROOM2_RADIUS)`` (80,000
    triangles at the default size), so the two instances share tables as
    the reference's two loads of one OBJ do."""
    dragon = MeshFromData(latlon_soup(lat, lon, ROOM2_RADIUS))
    return _room2(dragon, dragon)


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


def groups_scene(n_groups: int) -> SceneDefinition:
    """``n_groups`` distinct brute-force groups of 256 triangles each, in a
    row before the camera (16 KB of staged triangles a group): two fit the
    megakernel's shared-memory budget, from three on the kernel reads its
    tables from global memory."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.75 * (n_groups - 1), 0.3, 7.0],
                                [0.75 * (n_groups - 1), 0.0, 0.0]),
        fov=50.0, focus_dist=7.0))
    for i in range(n_groups):
        s.add_mesh(Transform(pos=[1.5 * i, 0.0, 0.0]),
                   MeshFromData(latlon_soup(8, 16, 0.5 + 0.01 * i)),
                   MaterialDefinition.new())
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


def _sponza_lights(s: SceneDefinition) -> None:
    """sponza's and bugatti's big quad light and emissive sphere
    (scene.rs:864-910, 934-983)."""
    s.add_mesh(Transform(pos=[-15.0, 60.0, 0.0], rot=quat_rotate_x(math.pi / 2),
                         scale=[40.0, 20.0, 1.0]),
               MeshFromData(MeshData.quad(),
                            indices=np.array([0, 1, 2, 0, 2, 3], np.uint32)),
               MaterialDefinition().emissive([1.0] * 4, 4.0))
    s.add_sphere([5.0, 2.0, 0.0], 2.0, MaterialDefinition(
        color=(1.0, 1.0, 1.0, 1.0), emission_color=(1.0, 1.0, 1.0, 1.0),
        emission_strength=10.0, specular_color=(1.0, 1.0, 1.0, 1.0),
        smoothness=0.0, specular=0.0))


def sponza() -> SceneDefinition:
    """scene.rs:864-910 (0.05 scale sponza + big quad light + emissive
    sphere). Without ``sponza.obj`` the mesh is the procedural atrium:
    41,424 triangles in 10 parts, one wide-BVH instance beside the light's
    2-triangle brute-force group and one dense sphere."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 4.0, 0.0], [0.0, 4.0, 1.0])))
    s.add_mesh(Transform(scale=[0.05, 0.05, 0.05]),
               MeshFromFile("sponza.obj", use_mtl=True),
               MaterialDefinition.texture_from_obj())
    _sponza_lights(s)
    return s


def cornell_box() -> SceneDefinition:
    """scene.rs:911-933 (needs ``CornellBox-Original.obj``)."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 1.0, 2.0], [0.0, 1.0, 0.0])))
    s.add_mesh(Transform(), MeshFromFile("CornellBox-Original.obj",
                                         use_mtl=True),
               MaterialDefinition.texture_from_obj())
    return s


def texture_test() -> SceneDefinition:
    """scene.rs:280-309 (earthmap-textured sphere; needs ``earthmap.png``).
    Its camera sits on the sphere's surface, as the reference's does."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 0.0, -1.0], [0.0, 0.0, 0.0])))
    s.add_sphere([0.0, 0.0, 0.0], 1.0, MaterialDefinition(
        color=(1.0, 0.0, 0.0, 1.0), specular_color=(1.0, 1.0, 1.0, 1.0),
        smoothness=0.0, specular=0.05, ior=1.0, flag=MaterialFlag.TEXTURE,
        diffuse_texture="earthmap.png"))
    return s


def obj_test() -> SceneDefinition:
    """scene.rs:310-364 (small dragon + quad + spheres; needs
    ``dragon.obj``)."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([5.0, 0.0, 0.0], [1.0, 0.0, 0.0]),
        fov=45.0, near=0.1, far=100.0, focus_dist=1.0))
    new = MaterialDefinition.new
    s.add_mesh(Transform(), MeshFromFile("dragon.obj", use_mtl=False), new())
    quad = MeshData.from_vertices(
        [[0.5, 0.0, -1.0], [0.5, 1.0, -1.0], [0.0, 1.0, 1.0], [0.2, 0.0, 1.0]],
        [[1, 0, 0]] * 4, indices=np.array([0, 1, 2, 0, 2, 3], np.uint32))
    s.add_mesh(Transform(), MeshFromData(quad),
               new().with_color([1.0, 1.0, 0.0, 1.0]).emissive([1, 0, 0, 1], 0.4))
    s.add_sphere([1.8, 0.1, 1.0], 0.6, new().with_color([1.0, 0.0, 0.0, 1.0]))
    s.add_sphere([1.0, 0.5, 1.0], 0.3, new().with_color([1.0, 0.0, 0.0, 1.0]))
    s.add_sphere([0.0, -10.0, 0.0], 10.0, new().with_color([1.0, 0.0, 0.0, 1.0]))
    return s


def bugatti() -> SceneDefinition:
    """scene.rs:934-983 (f1 car). Without ``f1/f1.obj`` the car is the
    procedural substitute: 4,124 triangles in 5 parts."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 0.0, 0.0], [0.0, 0.0, 1.0])))
    s.add_mesh(Transform(scale=[0.05, 0.05, 0.05]),
               MeshFromFile("f1/f1.obj", use_mtl=True),
               MaterialDefinition.texture_from_obj())
    _sponza_lights(s)
    return s


_BUILDERS = {
    SceneName.BALLS: balls,
    SceneName.RANDOM_BALLS: random_balls,
    SceneName.ROOM: room,
    SceneName.ROOM2: room_2,
    SceneName.METAL: metal,
    SceneName.SPONZA: sponza,
    SceneName.CORNELL_BOX: cornell_box,
}


def build_scene_definition(name: SceneName, assets=None) -> SceneDefinition:
    """Scene::from_name (scene.rs:1003-1014)."""
    if name == SceneName.EMPTY:
        raise NotImplementedError("Empty scene has no constructor (scene.rs:1012)")
    return _BUILDERS[name]()


# ---- textured stand-ins: seeded images instead of files -------------------
def seeded_image(size: int, seed: int, width: int | None = None) -> np.ndarray:
    """A (size, width or size, 4) float32 image on the u8/255 grid, opaque,
    made from ``seed``: a 16 x 16 grid of colour cells with per-texel noise
    of up to 24/255 over it."""
    w = size if width is None else width
    rng = np.random.default_rng(seed)
    cells = rng.integers(40, 216, (16, 16, 3))
    rgb = cells[(np.arange(size) * 16) // size][:, (np.arange(w) * 16) // w]
    rgb = np.clip(rgb + rng.integers(-24, 25, (size, w, 3)), 0, 255)
    img = np.full((size, w, 4), 255.0, np.float32)
    img[..., :3] = rgb
    return img / np.float32(255.0)


def textured_atrium_scene(assets, size: int = 1024, seed: int = 0,
                          every: int = 1) -> SceneDefinition:
    """``sponza()`` with its mesh textured: the procedural atrium's ten parts
    (``assets/sponza_builder.py:build_atrium``) as ``MeshFromData`` under
    sponza's transform, part k with ``MaterialDefinition().textured(<its
    material name>)`` where k % ``every`` == 0 (every part by default; with
    ``every=10`` one of the ten) and ``MaterialDefinition()`` otherwise;
    sponza's camera, quad light and emissive sphere. Each textured part's
    image is ``seeded_image(size, seed + k)``, registered in ``assets``
    (``AssetManager.add_texture``) under the material's name. At the
    default size the ten images are 10,485,760 texels, a 168 MB quad atlas:
    the size of the real sponza's atlas."""
    from ray_tracer_2_tpu_torch.assets.sponza_builder import build_atrium
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 4.0, 0.0], [0.0, 4.0, 1.0])))
    t = Transform(scale=[0.05, 0.05, 0.05])
    for k, (name, pos, nrm, uv) in enumerate(build_atrium()):
        mat = MaterialDefinition()
        if k % every == 0:
            assets.add_texture(name, seeded_image(size, seed + k))
            mat = mat.textured(name)
        s.add_mesh(t, MeshFromData(MeshData.from_vertices(pos, nrm, uv)), mat)
    _sponza_lights(s)
    return s


def texture_sphere_scene(assets, seed: int = 0) -> SceneDefinition:
    """``texture_test`` under the pulled-back camera of the reference's
    texture golden (``tests/test_goldens.py:21-34``: its own camera sits on
    the sphere), with a seeded 512 x 256 image (``seeded_image``)
    registered in ``assets`` as ``earthmap.png`` in place of the file."""
    assets.add_texture("earthmap.png", seeded_image(256, seed, 512))
    s = texture_test()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 0.0, -3.0], [0.0, 0.0, 0.0]),
        fov=45.0, focus_dist=3.0))
    return s


def normal_map_scene(assets) -> SceneDefinition:
    """The reference's normal-map test scene (``tests/test_normal_maps.py``
    :25-44): the unit quad before the camera with a 32 x 32 normal map,
    its flat half (128, 128, 255) and its half tilted toward +tangent x
    (255, 128, 128), registered in ``assets`` as ``test_nm`` as the loader
    would give the PNG: flipped horizontally."""
    img = np.zeros((32, 32, 4), np.float32)
    img[:, :16, :3] = (128, 128, 255)
    img[:, 16:, :3] = (255, 128, 128)
    img[..., 3] = 255
    assets.add_texture("test_nm", img[:, ::-1] / np.float32(255.0))
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 0.0, 3.0], [0.0, 0.0, 0.0]),
        fov=40.0, focus_dist=3.0))
    mat = dataclasses.replace(
        MaterialDefinition.new().with_color([0.7, 0.7, 0.7, 1.0]),
        normal_texture="test_nm")
    s.add_mesh(Transform(), MeshFromData(MeshData.quad(),
                                         indices=[0, 1, 2, 0, 2, 3]), mat)
    return s


def textured_variant(definition: SceneDefinition, assets, every: int = 1,
                     size: int = 64, seed: int = 0,
                     images: int = 8) -> SceneDefinition:
    """``definition`` with the material of every ``every``-th entity (from
    the first) textured: a textured counterpart of any scene, e.g. textured
    spheres among hundreds for the megakernel's sphere forms. The j-th
    textured entity samples ``texture<j % images>``, a seeded image of
    ``size`` x 2 ``size`` texels (``seeded_image(size, seed + j % images,
    2 * size)``) registered in ``assets``. The entities themselves are
    shared with ``definition``."""
    s = SceneDefinition()
    s.camera = definition.camera
    for k, e in enumerate(definition.entities):
        mat = e.material
        if k % every == 0:
            j = (k // every) % images
            name = f"texture{j}"
            assets.add_texture(name, seeded_image(size, seed + j, 2 * size))
            mat = mat.textured(name)
        s.entities.append(dataclasses.replace(e, material=mat))
    return s
