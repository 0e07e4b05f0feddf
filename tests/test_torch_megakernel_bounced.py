"""The port's persistent render against the reference's, with bounces.

Classes and setup as in tests/test_torch_megakernel.py: at bounces=3 the
plain PyTorch render is held to >= 70% of pixels within 1e-5 in every frame
and to the segment count over four frames within 1% of JAX
``render_persistent(fused_boundary=True)``; against the XLA boundary
(``fused_boundary=False``), whose op order it follows, to >= 99% of pixels
and segments within 0.5%.
"""
import numpy as np
import pytest

from torch_bridge import (
    frac_within, port_render as _port, ref_render as _ref, torch_scene,
    wide_bvh_render_scene,
)


@pytest.fixture(scope="module")
def scenes_():
    rs = wide_bvh_render_scene()
    return rs, torch_scene(rs)


def test_chaos_class(scenes_):
    rs, ts = scenes_
    seg_ref = seg_port = 0
    for f in range(4):
        a, sa = _ref(rs, f, bounces=3)
        b, sb = _port(ts, f, bounces=3)
        assert np.isfinite(b).all()
        assert frac_within(a, b) >= 0.70, f
        seg_ref += sa
        seg_port += sb
    assert abs(seg_ref - seg_port) <= 0.01 * seg_ref


def test_tight_against_xla_boundary(scenes_):
    rs, ts = scenes_
    a, sa = _ref(rs, 1, fused=False, bounces=3)
    b, sb = _port(ts, 1, bounces=3)
    assert frac_within(a, b) >= 0.99
    assert abs(sa - sb) <= 0.005 * sa
