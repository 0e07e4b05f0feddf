"""The scene the child-box test's edge tests render: what
``tests/test_torch_slab_edges.py`` checks of its tables and camera rays on
the CPU, and what ``tests/test_torch_cuda.py`` renders through the kernel
and its plain version on the card."""
import numpy as np

from ray_tracer_2_tpu_torch.math.transform import Transform
from ray_tracer_2_tpu_torch.scene.camera import CameraDescriptor
from ray_tracer_2_tpu_torch.scene.definition import (
    MeshData, MeshFromData, SceneDefinition,
)
from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene


def _cube_soup(lo) -> np.ndarray:
    """The 12 triangles of the unit cube with corner ``lo``, (12, 3, 3)."""
    c = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 np.float32) + np.asarray(lo, np.float32)
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = [(a, b, e) for a, b, e, _ in faces] + \
        [(a, e, f) for a, _, e, f in faces]
    return c[np.array(tris)]


VIEWS = ("planes", "minus_x", "plus_x", "planes_finite")
# the frame the tests render: odd, so the middle row and column are exact
WIDTH, HEIGHT = 129, 73


def slab_edges_scene(view: str = "planes",
                     slivers=(-7e4, 7e4)) -> SceneDefinition:
    """Rays at the edges of the wide rows' child-box test. One mesh of 36
    unit cubes on the integer grid (x -3..3, y 0..2, z 3..6: 432
    triangles, a wide BVH) and two slivers that reach x = -70,000 and
    x = +70,000, past f16's 65,504, so the boxes above them hold a lo of
    -inf and a hi of +inf; two spheres at x = -/+90,000. ``view``:
    ``planes``, the camera at (0, 1, 0) unrotated, looking down +z, so at
    an odd width and height the middle row's rays have y exactly 0 from
    y = 1 and the middle column's x exactly 0 from x = 0, on the planes of
    many child boxes (0 * inf); ``minus_x`` / ``plus_x``, the camera
    100,000 out on the x axis looking at the origin through its sphere
    (entered 4,000 away), so the sliver's box, entered at the plane its
    infinite bound is read as (34,464 away), must be pruned there;
    ``planes_finite``, the planes view without the slivers, so every child
    bound is finite and the kernel takes its loop without bound clamps.
    ``slivers`` gives the x at which each sliver ends (its sign, which
    side)."""
    s = SceneDefinition()
    if view.startswith("planes"):
        s.set_camera(CameraDescriptor(transform=Transform(pos=[0.0, 1.0, 0.0]),
                                      fov=70.0))
    else:
        x = -1e5 if view == "minus_x" else 1e5
        s.set_camera(CameraDescriptor(
            transform=Transform.cam([x, 0.5, -5.25], [0.0, 0.5, -5.25]),
            fov=70.0))
    cubes = [_cube_soup((x, y, z)) for x in range(-3, 3) for y in (0, 1)
             for z in range(3, 6)]
    if view == "planes_finite":
        slivers = ()
    tris = [[[x, 0.25, -5.5], [x, 0.75, -5.0], [-1.0, 0.5, -5.25]]
            if x < 0 else [[x, 0.25, -5.5], [1.0, 0.5, -5.25],
                           [x, 0.75, -5.0]] for x in slivers]
    soup = np.concatenate(cubes + [np.array(tris, np.float32)
                                   .reshape(-1, 3, 3)]).reshape(-1, 3)
    s.add_mesh(Transform(), MeshFromData(MeshData.from_vertices(
        soup, np.tile(np.float32([0.0, 1.0, 0.0]), (len(soup), 1)))),
        MaterialDefinition.new().with_color([0.7, 0.6, 0.5, 1.0]))
    for x in (-9e4, 9e4):
        s.add_sphere([x, 0.5, -5.25], 6000.0,
                     MaterialDefinition.new().with_color([0.3, 0.5, 0.8,
                                                          1.0]))
    return s


def instantiated(view: str, **kw):
    """``slab_edges_scene(view, **kw)`` instantiated on the CPU; the
    packer's cast of the slivers' bounds to f16 overflows to infinity, as
    it should, and its warning is silenced."""
    with np.errstate(over="ignore"):
        return instantiate_scene(slab_edges_scene(view, **kw))
