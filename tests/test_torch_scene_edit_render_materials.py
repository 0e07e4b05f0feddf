"""Renders of scenes after material edits (a colour, a glass toggle, a new
emitter, edits of an instance that shares its tables), held as in
tests/test_torch_scene_edit_render.py."""
import pytest

from torch_bridge import (  # noqa: F401
    EDIT_CASES, GEOMETRY_EDITS, check_edited_render, one_torch_thread,
)

CASES = tuple(sorted(set(EDIT_CASES) - set(GEOMETRY_EDITS)))


def test_material_cases():
    assert CASES == ("shared_material", "wide_colour", "wide_emitter",
                     "wide_glass")


@pytest.mark.parametrize("case", CASES)
def test_edited_scene_renders_as_the_reference(case, monkeypatch):
    check_edited_render(case, monkeypatch)
