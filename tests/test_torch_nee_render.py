"""Next-event estimation through the port's megakernel path, against JAX.

The plain PyTorch ``render_persistent(nee=True)`` is held against JAX
``render_persistent(fused_boundary=False, nee=True)``, the XLA boundary
whose op order it follows, at 48x27 on four scenes:

* ``room`` (two triangle lights, brute-force groups, glass): mode 1, the
  shadow ray tested inline against the prepass;
* ``balls`` (one sphere light): mode 1, cone sampling;
* ``room2_scene(12, 12)`` (a triangle light, two wide-BVH instances of one
  table, a brute-force group, glass, depth of field): mode 2, shadow
  segments;
* the reference's traversal scene (``tests/test_nee.py:159``): mode 2.

Class (c) at bounces 1 and 3 over frames 0 and 1: >= 99% of pixels within
1e-5 in each frame and segments within 2% over both. Measured: segments
exact in every cell and frame; pixels within 1e-5: room 100%, balls and
the traversal scene 99.92% (one pixel of 1,296), room2 99.92% at bounces
1 and 99.46-99.77% at 3 (the pixels apart carry ulps of XLA's arithmetic
through its 60-strength light).
"""
import numpy as np
import pytest

from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.kernels.megakernel import nee_mode
from ray_tracer_2_tpu_torch.scene import scenes
from torch_bridge import (
    frac_within, nee_definition, port_render, ref_definition, ref_render,
    torch_scene,
)
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

W, H = 48, 27

#: scene -> (definition, NEE mode)
SCENES = {
    "room": (scenes.room, 1),
    "balls": (scenes.balls, 1),
    "room2": (lambda: scenes.room2_scene(12, 12), 2),
    "traversal": (lambda: nee_definition("traversal"), 2),
}


@pytest.fixture(scope="module", params=list(SCENES))
def pair(request):
    make, mode = SCENES[request.param]
    rs = ref_instantiate(ref_definition(make())).render_scene
    ts = torch_scene(rs)
    assert ts.lights == rs.lights and nee_mode(ts, True) == mode
    return rs, ts


@pytest.mark.parametrize("bounces", [1, 3])
def test_nee_matches_reference(pair, bounces):
    rs, ts = pair
    kw = dict(width=W, height=H, bounces=bounces, nee=True)
    ref_segs = port_segs = 0
    for f in range(2):
        ref, rsegs = ref_render(rs, f, fused=False, **kw)
        img, segs = port_render(ts, f, **kw)
        assert np.isfinite(img).all()
        assert frac_within(ref, img) >= 0.99, f
        ref_segs, port_segs = ref_segs + rsegs, port_segs + segs
    assert abs(port_segs - ref_segs) <= 0.02 * ref_segs
