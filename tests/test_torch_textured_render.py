"""Textured shading through the port's megakernel path, against JAX.

The plain PyTorch ``render_persistent`` is held against JAX
``render_persistent(fused_boundary=False)``, the XLA boundary whose op
order it follows (its textured branch, resolve_and_shade :796-884), at
48x27 on:

* ``sphere``: ``texture_test``'s sphere pulled back
  (``scenes.texture_sphere_scene``), a seeded 512 x 256 image, sphere UVs;
* ``dominant``: a textured box (``torch_bridge.textured_box``: a
  288-triangle floor grid with UVs
  past [0, 1] in a wide BVH, a textured wall quad, a textured sphere, a
  quad light), three of its four materials textured, so ``texture_dominant``;
* ``few``: the same with only the wall textured;
* ``nee2`` and ``nee1``: the box with next-event estimation, its floor in
  a wide BVH (shadow segments, mode 2) and, at 128 triangles, a brute-force
  group (the shadow ray tested inline, mode 1);
* normal maps: in ``tests/test_torch_normal_maps.py``, to the same bars.

Both packages build the scene from one definition and one set of images
(``torch_bridge.ref_scene_pair``); the atlas is byte for byte the same
(``tests/test_torch_scene.py``). The bars are ROADMAP's classes. At bounces
0 a textured colour only weighs light gathered later, so (b) holds on the
textured box: every pixel within 1e-5. At bounces > 0, class (c): segments
within 1%, >= 98% of pixels within 1e-5 and >= 99.5% within 1e-4. What
keeps pixels apart is float rounding in the reference's XLA code, not the
port's: XLA's CPU backend contracts the sampler's ``u * w - 0.5`` and its
blend into FMAs (``tests/test_torch_textures.py``), and its ``acos`` and
``atan2`` of the sphere UVs round otherwise than libm's; a UV an ulp apart
moves a bilinear sample by up to 3e-5 where the texture is steep.
Measured (bounces 1 and 3): segments exact in every case, 98.69-99.92% of
pixels within 1e-5, every pixel within 1e-4 (largest difference 4.7e-5).
"""
import numpy as np
import pytest

from ray_tracer_2_tpu_torch.assets.manager import AssetManager
from ray_tracer_2_tpu_torch.kernels.megakernel import nee_mode
from ray_tracer_2_tpu_torch.scene import scenes
from torch_bridge import (
    frac_within, port_render, ref_render, ref_scene_pair, textured_box,
)
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

W, H = 48, 27


#: case -> (scene builder taking an AssetManager, render options, classes
#: the scene must carry, NEE mode)
CASES = {
    "sphere": (scenes.texture_sphere_scene, {},
               ("texture", "texture_dominant"), 0),
    "dominant": (textured_box, {}, ("texture", "texture_dominant"), 0),
    "few": (lambda a: textured_box(a, textured=("wall",)), {},
            ("texture",), 0),
    "nee2": (textured_box, dict(nee=True), ("texture", "texture_dominant"),
             2),
    "nee1": (lambda a: textured_box(a, cells=8), dict(nee=True),
             ("texture", "texture_dominant"), 1),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    build, opts, classes, mode = CASES[request.param]
    assets = AssetManager()
    rs, ts = ref_scene_pair(build(assets), assets)
    assert ts.shade_classes == classes == tuple(rs.shade_classes)
    assert nee_mode(ts, opts.get("nee", False)) == mode
    assert np.array_equal(np.asarray(rs.tex_texels).view(np.int32),
                          ts.tex_texels.numpy())
    return request.param, rs, ts, opts


#: the bounce counts each case renders at (each is a JAX compile)
BOUNCES = {"sphere": (1,), "dominant": (0, 3), "few": (3,), "nee2": (3,),
           "nee1": (3,)}


def test_textured_render_matches_reference(case):
    name, rs, ts, opts = case
    for bounces in BOUNCES[name]:
        kw = dict(width=W, height=H, bounces=bounces, **opts)
        ref, rsegs = ref_render(rs, 0, fused=False, **kw)
        img, segs = port_render(ts, 0, **kw)
        assert np.isfinite(img).all()
        if bounces == 0:
            assert segs == rsegs and frac_within(ref, img) == 1.0
            continue
        assert abs(segs - rsegs) <= 0.01 * rsegs, (segs, rsegs)
        assert frac_within(ref, img) >= 0.98, (bounces, frac_within(ref, img))
        assert frac_within(ref, img, 1e-4) >= 0.995
        assert (img[..., :3] > 0).any(axis=-1).mean() >= 0.1
    if "normal_maps" in opts:   # the maps change what they shade
        off, _ = port_render(ts, 0, **dict(kw, normal_maps=False))
        assert np.abs(off - img).max() > 0.02
