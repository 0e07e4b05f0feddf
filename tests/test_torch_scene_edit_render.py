"""Renders of edited scenes, sphere and instance edits (material edits:
tests/test_torch_scene_edit_render_materials.py, a file per xdist worker):
the port's plain ``render_persistent`` against JAX
``render_persistent(fused_boundary=False)`` (the XLA boundary, whose op
order the port follows) after the same live edits on both sides
(``torch_bridge.EDIT_CASES``), at 32x16 from frame 1
(``torch_bridge.check_edited_render``):

* bounces 0, class (b): segments exact, >= 99% of pixels within 1e-5;
* bounces 2, class (c) against the XLA boundary: segments within 0.5%,
  >= 99% of pixels within 1e-5.

The cases with lights render with next-event estimation, so the refreshed
light table is what is sampled.
"""
import pytest

from torch_bridge import (  # noqa: F401
    GEOMETRY_EDITS, check_edited_render, one_torch_thread,
)


@pytest.mark.parametrize("case", GEOMETRY_EDITS)
def test_edited_scene_renders_as_the_reference(case, monkeypatch):
    check_edited_render(case, monkeypatch)
