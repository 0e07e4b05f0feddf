"""Scene-building API (port of ``ray_tracer_2_tpu/scene/definition.py``;
ref: src/scene/{scene,entity}.rs).

``SceneDefinition`` collects entities (spheres / meshes with transforms and
materials) plus a camera. A mesh is given as data or named by its OBJ file,
which the asset manager loads (``assets/manager.py``). Instantiation into
tensors lives in ``render_scene.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from ray_tracer_2_tpu_torch.math.transform import Transform
from ray_tracer_2_tpu_torch.scene.camera import Camera, CameraDescriptor
from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition


@dataclasses.dataclass
class MeshData:
    """Triangle-soup mesh: de-indexed SoA arrays (mesh.rs:8-13)."""

    positions: np.ndarray   # (V, 3) float32
    normals: np.ndarray     # (V, 3) float32
    uvs: np.ndarray         # (V, 2) float32
    indices: np.ndarray     # (3T,) uint32 into the arrays above

    @staticmethod
    def from_vertices(positions, normals, uvs=None, indices=None) -> "MeshData":
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        normals = np.asarray(normals, np.float32).reshape(-1, 3)
        if uvs is None:
            uvs = np.zeros((len(positions), 2), np.float32)
        if indices is None:
            indices = np.arange(len(positions), dtype=np.uint32)
        return MeshData(positions, normals,
                        np.asarray(uvs, np.float32).reshape(-1, 2),
                        np.asarray(indices, np.uint32))

    @staticmethod
    def quad() -> "MeshData":
        """Unit XY quad with UVs (mesh.rs:23-31); callers index [0,1,2,0,2,3]."""
        pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                       np.float32)
        n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        return MeshData(pos, n, uv, np.arange(4, dtype=np.uint32))

    def triangle_count(self) -> int:
        return len(self.indices) // 3


@dataclasses.dataclass
class MeshFromFile:
    """A mesh named by its OBJ file, resolved through the asset manager's
    search paths (or, for a file the repository lacks, its procedural
    substitute: ``assets/procedural.py``); ``use_mtl`` takes each part's
    material from the file's MTL."""

    path: str
    use_mtl: bool = False


@dataclasses.dataclass
class MeshFromData:
    data: MeshData
    indices: Optional[np.ndarray] = None  # optional override index buffer

    def resolved(self) -> MeshData:
        if self.indices is None:
            return self.data
        return MeshData(self.data.positions, self.data.normals, self.data.uvs,
                        np.asarray(self.indices, np.uint32))


@dataclasses.dataclass
class SphereDef:
    centre: np.ndarray
    radius: float


@dataclasses.dataclass
class EntityDefinition:
    """entity.rs:7-16."""

    transform: Transform
    primitive: Union[SphereDef, MeshFromData, MeshFromFile]
    material: MaterialDefinition


class SceneDefinition:
    """scene.rs:70-107."""

    def __init__(self):
        self.camera = Camera(CameraDescriptor())
        self.entities: list[EntityDefinition] = []

    def set_camera(self, desc: CameraDescriptor) -> None:
        self.camera = Camera(desc)

    def add_sphere(self, centre, radius: float,
                   material: MaterialDefinition) -> None:
        self.entities.append(EntityDefinition(
            transform=Transform(),
            primitive=SphereDef(np.asarray(centre, np.float32), float(radius)),
            material=material,
        ))

    def add_mesh(self, transform: Transform,
                 mesh: Union[MeshFromData, MeshFromFile],
                 material: MaterialDefinition) -> None:
        self.entities.append(EntityDefinition(
            transform=transform, primitive=mesh, material=material))
