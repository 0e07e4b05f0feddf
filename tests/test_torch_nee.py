"""Next-event estimation in the port: the light table and the plain
version's own identities, against the JAX package where it has a table.

* Light tables (``TorchScene.lights``) byte-identical to the reference's
  ``RenderScene.lights`` on the built-in scenes and on the asset-free
  scenes of the reference's ``tests/test_nee.py``: no lights (``metal``),
  the ceiling quad (``room``), the sun sphere (``balls``: its radius in
  v1.x), room2, a light under the identity and mirrored (v1 and v2
  swapped, so its front still faces down), emissive glass (no light) and a
  light inside a wide-BVH instance.
* Mode 1 (the shadow ray tested inline) and mode 2 forced (shadow
  segments) give one image; mode 2 counts one segment more per shadow ray.
* The far-instance pair: a scene without traversal (mode 1) and the same
  view with a wide-BVH instance far out of sight (mode 2) render alike.
* Cone sampling of a sphere light: every raw frame value lies on the
  closed form or, where a grazing shadow ray flips, on 0.
* ``nee=True`` on a scene without lights renders the ``nee=False`` image.

The images against JAX ``render_persistent`` are in
``tests/test_torch_nee_render.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import oracle
from ray_tracer_2_tpu.scene import scenes as ref_scenes
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.config import RenderParams
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels.megakernel import (
    light_tables, nee_mode, render_plain,
)
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
from torch_bridge import (
    nee_definition, ref_definition, torch_scene,
)
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

W, H = 40, 24

#: scene -> (port definition, the reference's, number of lights)
TABLES = {
    "metal": (scenes.metal, ref_scenes.metal, 0),
    "room": (scenes.room, ref_scenes.room, 2),
    "balls": (scenes.balls, ref_scenes.balls, 1),
    "room2": (lambda: scenes.room2_scene(12, 12), None, 2),
    "plain_light": (lambda: nee_definition("plain_light"), None, 2),
    "mirrored_light": (lambda: nee_definition("mirrored_light"), None, 2),
    "emissive_glass": (lambda: nee_definition("emissive_glass"), None, 0),
    "light_in_instance": (lambda: nee_definition("light_in_instance"), None,
                          2),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_light_table_matches_reference(name):
    """Same rows, same Python types, same float bits."""
    make, ref_make, n = TABLES[name]
    ts = instantiate_scene(make())
    ref = ref_instantiate(ref_make() if ref_make
                          else ref_definition(make())).render_scene.lights
    assert len(ts.lights) == n == len(ref)
    assert ts.lights == ref
    assert [[type(v) for v in row] for row in ts.lights] == \
        [[type(v) for v in row] for row in ref]
    if n:
        assert np.asarray(ts.lights).tobytes() == np.asarray(ref).tobytes()


def test_light_tables_for_the_sampler():
    """``light_tables``: rows of kind, v0, v1, v2, unit normal, radiance;
    the float32 cdf ends at 1; the two constants in float32."""
    ts = instantiate_scene(scenes.room())
    lt = light_tables(ts)
    rows = lt["rows"].numpy()
    assert rows.shape == (2, 16) and rows.dtype == np.float32
    n = rows[:, 10:13]
    assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)
    assert np.allclose(n[:, 1], -1.0, atol=1e-6)      # the ceiling faces down
    assert float(lt["cdf"][-1]) == pytest.approx(1.0, abs=1e-6)
    area = sum(row[13] for row in ts.lights)
    assert lt["c_area"] == float(np.float32(area))
    assert lt["c_tri"] == float(np.float32(area / (2.0 * np.pi)))
    assert light_tables(ts) is lt


def test_modes():
    """0 without lights or without ``nee``; 1 without a traversal phase; 2
    with a wide-BVH instance (room2; the light inside the instance), with
    the sphere BVH, or when forced."""
    room = instantiate_scene(scenes.room())
    assert nee_mode(room, False) == 0
    assert nee_mode(instantiate_scene(scenes.metal()), True) == 0
    assert nee_mode(room, True) == 1 and nee_mode(room, True, True) == 2
    assert nee_mode(instantiate_scene(scenes.room2_scene(12, 12)), True) == 2
    sunlit = instantiate_scene(scenes.sunlit_balls(), sphere_bvh=True)
    assert sunlit.sphere_bvh_root >= 0 and nee_mode(sunlit, True) == 2
    inside = instantiate_scene(nee_definition("light_in_instance"))
    assert len(inside.inst_spans) == 1 and inside.inst_spans[0][2] > 1024
    assert nee_mode(inside, True) == 2


@pytest.mark.parametrize("bounces", [1, 3])
def test_segments_mode_renders_the_inline_image(bounces):
    """Mode 1 and forced mode 2 on ``room``: pixel-identical, and mode 2
    counts one segment more for each shadow ray (those are pixels whose
    count went up, and never down)."""
    ts = instantiate_scene(scenes.room())
    kw = dict(width=W, height=H, bounces=bounces, rays_per_pixel=1,
              skybox=True, nee=True)
    c1, c2 = {}, {}
    a, s1 = render_plain(ts, 1, counts=c1, **kw)
    b, s2 = render_plain(ts, 1, nee_segments=True, counts=c2, **kw)
    assert torch.equal(a, b)
    extra = c2["pixel_segments"] - c1["pixel_segments"]
    assert int(extra.min()) >= 0 and int(s2) - int(s1) == int(extra.sum())
    assert int(extra.sum()) > 0.1 * W * H


def test_far_instance_view_matches_inline():
    """The reference's far-instance pair (test_nee.py:248): the floor and
    light alone (mode 1) and with a 1,080-triangle instance out of every
    ray's reach (mode 2, shadow segments through the traversal): the same
    progressive image over three frames, rpp 2, 3 bounces."""
    out = []
    for name in ("view", "view_far"):
        ts = instantiate_scene(nee_definition(name))
        renderer = Renderer(device="cpu")
        params = RenderParams(width=W, height=H, bounces=3,
                              rays_per_pixel=2, skybox=False, nee=True)
        for f in range(3):
            renderer.render(ts, dataclasses.replace(params, frames=f))
        out.append((nee_mode(ts, True), renderer.read_framebuffer()))
    (m1, a), (m2, b) = out
    assert (m1, m2) == (1, 2)
    assert np.array_equal(a, b) and (a[..., :3] > 0).any()


def test_sphere_light_cone_sampling_is_exact():
    """The reference's closed-form check (test_nee.py:305) through the
    port: with one sphere light, no sky and one bounce, each raw frame
    value sits on Le (the light's silhouette), on albedo * Le * (1 -
    cos_max) (the ground) or, where a grazing shadow ray flips the f32
    occlusion test, on 0; >= 97% on the expected point."""
    albedo = np.array([0.6, 0.55, 0.5])
    le = np.array([1.0, 0.9, 0.7]) * 10.0
    lc, lr = np.array([0.0, 2.0, 0.0]), 0.5
    rs = ref_instantiate(ref_definition(nee_definition("cone"))).render_scene
    ts = torch_scene(rs)
    assert len(ts.lights) == 1 and ts.lights[0][0] == 1
    renderer = Renderer(device="cpu")
    params = RenderParams(width=W, height=H, bounces=1, rays_per_pixel=1,
                          skybox=False, nee=True)
    per = []
    for f in range(4):
        renderer.render(ts, dataclasses.replace(params, frames=f))
        per.append(renderer.read_framebuffer().copy())
    raws = [per[0]] + [per[f] * (f + 1) - per[f - 1] * f
                       for f in range(1, len(per))]
    spheres = oracle.spheres_from_scene(rs)
    m = np.asarray(oracle.camera_from_scene(rs)["cam_to_world"], np.float64)
    vp = np.asarray(oracle.camera_from_scene(rs)["view_params"], np.float64)
    exp = np.zeros((H, W, 3))
    for y in range(H):
        for x in range(W):
            lf = np.array([(x / (W - 1) - 0.5) * vp[0],
                           (y / (H - 1) - 0.5) * vp[1], vp[2]])
            d = m[:3, :3] @ lf
            h = oracle.closest_hit(spheres, m[:3, 3].astype(np.float32),
                                   (d / np.linalg.norm(d)).astype(np.float32))
            if h is None:
                continue
            if h["mat"]["emission_strength"] > 0:
                exp[y, x] = le
                continue
            cvec = lc - np.asarray(h["point"], np.float64)
            dl = np.linalg.norm(cvec)
            if np.dot(np.asarray(h["normal"], np.float64), cvec / dl) <= 0:
                continue
            exp[y, x] = albedo * le * (1.0 - np.sqrt(max(1.0 - (lr / dl) ** 2,
                                                         0.0)))
    tol = 1e-3 + 2e-3 * np.abs(exp).max(axis=-1)
    on_exp = np.zeros((len(raws), H, W), bool)
    on_zero = np.zeros_like(on_exp)
    for f, raw in enumerate(raws):
        err = np.abs(raw[..., :3].astype(np.float64) - exp).max(axis=-1)
        on_exp[f] = err <= tol * (f + 2)
        on_zero[f] = np.abs(raw[..., :3]).max(axis=-1) <= 1e-3 * (f + 2)
    assert (on_exp | on_zero).mean() >= 0.98, (on_exp | on_zero).mean()
    assert on_exp.mean() >= 0.97, on_exp.mean()


@pytest.mark.parametrize("name", ["metal", "wide_bvh"])
def test_nee_without_lights_is_plain(name):
    """A scene without lights ignores ``nee``: the megakernel's image and
    segments without it, on spheres and on a wide-BVH mesh."""
    definition = scenes.wide_bvh_scene() if name == "wide_bvh" \
        else scenes.metal()
    ts = instantiate_scene(definition)
    assert ts.lights == () and nee_mode(ts, True) == 0
    kw = dict(width=W, height=H, bounces=2, rays_per_pixel=1, skybox=True)
    a, sa = render_plain(ts, 1, **kw)
    b, sb = render_plain(ts, 1, nee=True, **kw)
    assert torch.equal(a, b) and int(sa) == int(sb)
