"""The port's megakernel outside the fused class, against the reference.

The plain PyTorch ``render_persistent`` is held against JAX
``render_persistent`` with the XLA boundary (``fused=False``), whose op
order it follows, at 48x27 on:

* room2 (``scenes.room2_scene``) with a 12x12 soup: two instances of one
  shared 288-triangle table with material-id deltas, a 16-triangle
  brute-force group, a glass sphere, depth of field at ``defocus 100``;
* ``scenes.instances_scene``: four instances of two shared soups, each
  pair under two transforms and two materials, a 300-triangle one
  traversed in its wide BVH and a 72-triangle one tested brute force, so
  the shading has to take each hit's normal through its own instance's
  transform;
* a brute-force-only mesh of 72 triangles (``wide_bvh_scene(4, 9)``).

Classes (ROADMAP): at bounces 0 (b) segments exact and every pixel within
1e-5 (measured: 5.7e-6 at most on room2 over frames 0-3); at bounces 3 (c)
segments within 2% over four frames and >= 99% of pixels within 1e-5 in
each (measured: segments exact on room2, one off in 6,450 on the 72-triangle
mesh; >= 99.77% of pixels). ``room`` with antialias, which also takes this
path, is held in tests/test_torch_renderer.py.
"""
import numpy as np
import pytest

from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.scene import scenes
from torch_bridge import (
    frac_within, port_render, ref_definition, ref_render, torch_scene,
)
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

W, H = 48, 27


SCENES = {
    "room2": lambda: scenes.room2_scene(12, 12),
    "instances": scenes.instances_scene,
    "brute_only": lambda: scenes.wide_bvh_scene(lat=4, lon=9),
}


@pytest.fixture(scope="module", params=list(SCENES))
def pair(request):
    rs = ref_instantiate(ref_definition(SCENES[request.param]())) \
        .render_scene
    return request.param, rs, torch_scene(rs)


def test_scene_shapes(pair):
    name, rs, ts = pair
    spans, deltas = ts.inst_spans, ts.inst_mat_deltas
    if name == "room2":
        assert spans == ((0, 0, 288), (0, 0, 288), (95, 288, 16))
        assert deltas == (0, 1, 0) and ts.shade_classes == ("glass",)
    elif name == "instances":
        assert [c for _, _, c in spans] == [300, 72, 300, 72]
        assert spans[0] == spans[2] and spans[1] == spans[3]
        assert deltas == (0, 0, 2, 2)
    else:
        assert spans == ((0, 0, 72),)


def test_primary_class(pair):
    name, rs, ts = pair
    for f in (1, 2):
        a, sa = ref_render(rs, f, fused=False, width=W, height=H)
        b, sb = port_render(ts, f, width=W, height=H)
        assert sa == sb == W * H, (name, f)
        assert np.isfinite(b).all()
        assert frac_within(a, b) == 1.0, (name, f)
    assert float((b[..., :3] > 0).any(axis=-1).mean()) >= 0.1


def test_chaos_class(pair):
    name, rs, ts = pair
    seg_ref = seg_port = 0
    for f in range(4):
        a, sa = ref_render(rs, f, fused=False, width=W, height=H, bounces=3)
        b, sb = port_render(ts, f, width=W, height=H, bounces=3)
        assert np.isfinite(b).all()
        assert frac_within(a, b) >= 0.99, (name, f)
        seg_ref += sa
        seg_port += sb
    assert abs(seg_ref - seg_port) <= 0.02 * seg_ref, name
