"""Materials: the host-side builder API (port of
``ray_tracer_2_tpu/scene/material.py`` without the jax ``MaterialTable``
pytree; the device reads the packed ``mat_rows`` table instead).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class MaterialFlag(enum.IntEnum):
    """material.rs:38-43."""

    DEFAULT = 0
    GLASS = 1
    TEXTURE = 2


@dataclasses.dataclass
class MaterialRecord:
    """One resolved material — field-for-field the reference's
    ``MaterialUniform`` (material.rs:3-36), with texture slots resolved to
    atlas indices (-1 = none)."""

    color: tuple = (0.7, 0.7, 0.7, 1.0)
    emission_color: tuple = (0.0, 0.0, 0.0, 0.0)
    specular_color: tuple = (0.0, 0.0, 0.0, 0.0)
    absorption: tuple = (0.0, 0.0, 0.0, 0.0)
    absorption_strength: float = 0.0
    emission_strength: float = 0.0
    smoothness: float = 0.9
    specular: float = 0.0
    ior: float = 1.0
    flag: int = MaterialFlag.DEFAULT
    diffuse_index: int = -1
    normal_index: int = -1


@dataclasses.dataclass
class MaterialDefinition:
    """Fluent material builder (material.rs:88-130). ``new()`` matches the
    reference's ``MaterialDefinition::new`` and the dataclass defaults its
    Rust ``Default`` impl — they differ, and scenes use both."""

    color: tuple = (0.7, 0.7, 0.7, 1.0)
    emission_color: tuple = (0.0, 0.0, 0.0, 0.0)
    specular_color: tuple = (1.0, 1.0, 1.0, 1.0)
    absorption: tuple = (0.0, 0.0, 0.0, 0.0)
    absorption_strength: float = 0.0
    emission_strength: float = 0.0
    smoothness: float = 1.0
    specular: float = 0.0
    ior: float = 1.0
    flag: int = MaterialFlag.DEFAULT
    diffuse_texture: Optional[str] = None
    normal_texture: Optional[str] = None

    @staticmethod
    def new() -> "MaterialDefinition":
        return MaterialDefinition(
            color=(1.0, 1.0, 1.0, 1.0),
            emission_color=(1.0, 1.0, 1.0, 1.0),
            specular_color=(1.0, 1.0, 1.0, 1.0),
            smoothness=0.0,
            specular=0.1,
            ior=0.0,
        )

    @staticmethod
    def texture_from_obj() -> "MaterialDefinition":
        # Reference quirk preserved (material.rs:61-67): flag GLASS — masked in
        # practice because use_mtl meshes take materials from the .mtl file.
        return MaterialDefinition(flag=MaterialFlag.GLASS)

    def with_color(self, color) -> "MaterialDefinition":
        return dataclasses.replace(self, color=tuple(color))

    def emissive(self, color, strength: float) -> "MaterialDefinition":
        return dataclasses.replace(self, emission_color=tuple(color),
                                   emission_strength=strength)

    def glass(self, ior: float) -> "MaterialDefinition":
        return dataclasses.replace(self, ior=ior, flag=MaterialFlag.GLASS)

    def specular_(self, color, specular: float) -> "MaterialDefinition":
        return dataclasses.replace(self, specular_color=tuple(color),
                                   specular=specular)

    def smooth(self, smoothness: float) -> "MaterialDefinition":
        return dataclasses.replace(self, smoothness=smoothness)

    def textured(self, path: str) -> "MaterialDefinition":
        return dataclasses.replace(self, diffuse_texture=path)

    def resolve(self, diffuse_index: int = -1,
                normal_index: int = -1) -> MaterialRecord:
        """Resolve to a record (scene.rs:204-217) with the atlas slots the
        asset manager gave the textures (-1: none): a loaded diffuse texture
        forces the TEXTURE flag."""
        flag = int(self.flag)
        if self.diffuse_texture is not None and diffuse_index >= 0:
            flag = int(MaterialFlag.TEXTURE)
        return MaterialRecord(
            color=tuple(self.color),
            emission_color=tuple(self.emission_color),
            specular_color=tuple(self.specular_color),
            absorption=tuple(self.absorption),
            absorption_strength=self.absorption_strength,
            emission_strength=self.emission_strength,
            smoothness=self.smoothness,
            specular=self.specular,
            ior=self.ior,
            flag=flag,
            diffuse_index=diffuse_index,
            normal_index=normal_index,
        )
