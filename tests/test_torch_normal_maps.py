"""Normal maps through the port's megakernel path, against JAX.

``RenderParams.normal_maps`` (reference resolve_and_shade :805-824): a mesh
hit whose material names a normal map shades with the map's normal, decoded
as 2 n - 1 and rotated out of the triangle's tangent frame (the tangent and
handedness of ``accel/packed.py``'s attribute rows, through the instance's
transform, made orthogonal to the normal). The plain PyTorch
``render_persistent(normal_maps=True)`` is held against JAX
``render_persistent(fused_boundary=False, normal_maps=True)`` at 48x27 on
the reference's normal-map quad (``tests/test_normal_maps.py``;
``scenes.normal_map_scene``: its map made in numpy) and on the textured box
of ``tests/test_torch_textured_render.py`` with a seeded normal map on its
floor (a wide BVH), to that file's class (c) bars; and the maps must change
the image. Measured: segments exact, 99.92% (quad) and 98.77% (box) of
pixels within 1e-5, every pixel within 1e-4.
"""
import numpy as np
import pytest

from ray_tracer_2_tpu_torch.assets.manager import AssetManager
from ray_tracer_2_tpu_torch.scene import scenes
from torch_bridge import (
    frac_within, port_render, ref_render, ref_scene_pair, textured_box,
)
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

W, H = 48, 27

#: case -> (scene builder, bounces, classes the scene must carry)
CASES = {
    "quad": (scenes.normal_map_scene, 2, ("normal_map",)),
    "box": (lambda a: textured_box(a, floor_normal_map=True), 3,
            ("texture", "texture_dominant", "normal_map")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_normal_maps_match_reference(name):
    build, bounces, classes = CASES[name]
    assets = AssetManager()
    rs, ts = ref_scene_pair(build(assets), assets)
    assert ts.shade_classes == classes == tuple(rs.shade_classes)
    kw = dict(width=W, height=H, bounces=bounces)
    ref, rsegs = ref_render(rs, 0, fused=False, normal_maps=True, **kw)
    img, segs = port_render(ts, 0, normal_maps=True, **kw)
    assert np.isfinite(img).all()
    assert abs(segs - rsegs) <= 0.01 * rsegs, (segs, rsegs)
    assert frac_within(ref, img) >= 0.98
    assert frac_within(ref, img, 1e-4) >= 0.995
    off, _ = port_render(ts, 0, **kw)
    assert np.abs(off - img).max() > 0.02
