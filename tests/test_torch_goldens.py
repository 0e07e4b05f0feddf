"""The port against the repository's goldens and the analytic furnace.

``tests/goldens/*.npz`` pin the JAX path bit for bit (small fixed-seed
progressive renders, ``scripts/make_goldens.py``). The port draws the same
random numbers but rounds differently inside a segment, so single paths
diverge; it is held to the goldens statistically, never bit for bit. For
each asset-free golden the port renders the golden's own configuration
twice: through ``Renderer(device="cpu")`` (so the routing and the
progressive blend are under test; every golden's scene is a small one, so
all but ``metal_aa`` go through ``render_spheres``) and as the mean of its
frames through ``render_persistent`` (the megakernel's plain version; for
``metal_aa`` the two are one path). ``bugatti`` (96x54, 3 bounces, 6
frames: the procedural substitute of ``f1/f1.obj``, 4,124 triangles in a
wide BVH, its quad light a brute-force group, an emissive sphere) is no
small scene: ``Renderer`` sends it to ``render_persistent``, so it has the
one path. Either way it must satisfy:

* the band: the RMSE between the port's mean image and the golden (both
  clipped to [0, 4], as ``tests/test_goldens.py`` clips) is at most
  ``sqrt(2) * sigma / sqrt(N)``, with ``sigma^2`` the mean per-pixel
  variance of the port's own N frames: what two independent N-frame means of
  one estimator would show. The two share their random streams, so the
  measured RMSE lies far inside the band (7e-8 on ``room``, 0.002-0.014 on
  the others, against bands of 0.095-0.18). The band is at least 1e-6, the
  float rounding between the two packages: ``bugatti``'s frames are one
  image (its camera sees the small car against the sky, and its 148 extra
  segments end the same way every frame), so its sigma is rounding alone
  (2e-8; measured RMSE 3e-8);
* no bias: the two images' means agree within 1% (measured: within 0.04%);
* the chaos class: because the streams are shared, most pixels agree
  outright: >= 95% within 1e-5 (measured: 97.5% on ``random_balls``, 99.2%
  and more on the others).

The furnace needs no reference at all (``tests/test_furnace.py``): inside a
closed cube of albedo ``a`` that emits ``E`` at every hit, the expected
radiance with ``b`` bounces is ``E (1 - a^(b+1)) / (1 - a)``; the mean over
pixels and 24 frames must land within 2% of it: through ``Renderer``
without antialias (``render_spheres``: 12 world-baked triangles) and with
it (the megakernel, where the cube is a brute-force group), and through
``render_persistent`` without antialias.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tracer_2_tpu_torch.config import RenderParams
from ray_tracer_2_tpu_torch.engine.renderer import Renderer, small_scene
from ray_tracer_2_tpu_torch.kernels.megakernel import render_persistent
from ray_tracer_2_tpu_torch.kernels.spheres import render_spheres
from ray_tracer_2_tpu_torch.math.transform import Transform
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.camera import CameraDescriptor
from ray_tracer_2_tpu_torch.scene.definition import SceneDefinition
from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = Path(__file__).parent / "goldens"
#: golden -> the function that makes its scene in the port
SCENES = {"balls": scenes.balls, "metal": scenes.metal,
            "metal_aa": scenes.metal, "room": scenes.room,
            "random_balls": scenes.random_balls, "bugatti": scenes.bugatti}
#: goldens whose scene is not a small one: one path, through the renderer
ONE_PATH = ("metal_aa", "bugatti")


def _clip(img):
    return np.clip(np.asarray(img)[..., :3], 0.0, 4.0)


def _sample_fn(scene, antialias):
    """The frame renderer that ``Renderer`` routes ``scene`` to."""
    if small_scene(scene) and not antialias:
        return render_spheres
    return lambda *a, **k: render_persistent(*a, antialias=antialias, **k)


@pytest.mark.parametrize("name,path", [(n, "renderer") for n in sorted(SCENES)]
                         + [(n, "render_persistent") for n in sorted(SCENES)
                            if n not in ONE_PATH])
def test_golden_statistically(name, path):
    with np.load(GOLDEN_DIR / f"{name}.npz") as z:
        golden = _clip(z["framebuffer"])
        cfg = {k: int(z[k]) for k in ("width", "height", "bounces", "frames")}
        antialias = bool(int(z["antialias"])) if "antialias" in z else False
    n = cfg.pop("frames")
    scene = instantiate_scene(SCENES[name]())
    assert small_scene(scene) == (name != "bugatti")
    params = RenderParams(rays_per_pixel=1, skybox=True, antialias=antialias,
                          **cfg)
    r = Renderer(device="cpu")
    frames = []
    kw = dict(rays_per_pixel=1, skybox=True, **cfg)
    sample_fn = _sample_fn(scene, antialias) if path == "renderer" \
        else render_persistent
    for f in range(n):
        if path == "renderer":
            r.render(scene, dataclasses.replace(params, frames=f))
        # the same frame alone, for the estimator's variance
        frames.append(sample_fn(scene, f, **kw)[0].numpy())
    port = _clip(r.read_framebuffer() if path == "renderer"
                 else np.mean(np.stack(frames), axis=0))
    frames = [_clip(s) for s in frames]
    assert port.shape == golden.shape and np.isfinite(port).all()
    sigma = float(np.sqrt(np.var(np.stack(frames), axis=0, ddof=1).mean()))
    band = max(np.sqrt(2.0) * sigma / np.sqrt(n), 1e-6)
    err = float(np.sqrt(np.mean((port - golden) ** 2)))
    assert 0.0 < sigma and err <= band, (err, band)
    assert abs(port.mean() - golden.mean()) <= 0.01 * golden.mean(), \
        (port.mean(), golden.mean())
    assert float((np.abs(port - golden).max(axis=-1) < 1e-5).mean()) >= 0.95


def _furnace_scene(albedo: float, emission: float) -> SceneDefinition:
    """The closed cube furnace of ``tests/test_furnace.py``: twelve
    inward-facing triangles of one material that emits ``emission`` and
    reflects ``albedo`` with no specular lobe, the camera at the centre."""
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam([0.0, 0.0, 0.0], [0.0, 0.0, -1.0]),
        fov=60.0, focus_dist=1.0))
    mat = (MaterialDefinition.new().with_color([albedo] * 3 + [1.0])
           .specular_([1.0] * 4, 0.0)
           .emissive([emission] * 3 + [0.0], 1.0))
    h = 5.0
    walls = [
        ([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h]],
         [0, 0, 1], [0, 1, 2, 0, 2, 3]),
        ([[-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]],
         [0, 0, -1], [2, 1, 0, 3, 2, 0]),
        ([[-h, -h, -h], [-h, -h, h], [-h, h, h], [-h, h, -h]],
         [1, 0, 0], [2, 1, 0, 3, 2, 0]),
        ([[h, -h, -h], [h, -h, h], [h, h, h], [h, h, -h]],
         [-1, 0, 0], [0, 1, 2, 0, 2, 3]),
        ([[-h, -h, -h], [h, -h, -h], [h, -h, h], [-h, -h, h]],
         [0, 1, 0], [2, 1, 0, 3, 2, 0]),
        ([[-h, h, -h], [h, h, -h], [h, h, h], [-h, h, h]],
         [0, -1, 0], [0, 1, 2, 0, 2, 3]),
    ]
    for verts, normal, idx in walls:
        s.add_mesh(Transform(), scenes._quad_mesh(verts, normal, idx), mat)
    return s


@pytest.mark.parametrize("path", ["renderer", "renderer_antialias",
                                  "render_persistent"])
def test_furnace_matches_closed_form(path):
    albedo, emission, bounces, n = 0.5, 0.3, 6, 24
    scene = instantiate_scene(_furnace_scene(albedo, emission))
    assert scene.inst_spans == ((0, 0, 12),) and small_scene(scene)
    kw = dict(width=64, height=32, bounces=bounces, rays_per_pixel=1,
              skybox=False)
    if path == "render_persistent":
        fb = torch.stack([render_persistent(scene, f, **kw)[0]
                          for f in range(n)]).mean(dim=0)
    else:
        params = RenderParams(antialias=path.endswith("antialias"), **kw)
        r = Renderer(device="cpu")
        for f in range(n):
            fb = r.render(scene, dataclasses.replace(params, frames=f))
    assert bool(torch.isfinite(fb).all())
    expected = emission * (1.0 - albedo ** (bounces + 1)) / (1.0 - albedo)
    measured = float(fb[..., :3].mean())
    assert abs(measured - expected) / expected < 0.02, (measured, expected)
