"""Asset manager: thread-safe caching loader for models and textures (port
of ``ray_tracer_2_tpu/assets/manager.py``; ref: src/core/asset.rs).

Differences from the Rust reference, by design (the JAX package's):
  * search-path list instead of one hardcoded ``assets/`` dir (the reference
    resolves against CARGO_MANIFEST_DIR, asset.rs:50,71);
  * mesh cache keyed by (file path, object, material) instead of object name
    only — fixes the cross-file collision defect noted in SURVEY.md §7.

The default search path is the repository's ``assets/`` directory; the
``RT2_TPU_ASSETS`` environment variable, then ``search_dirs``, go before
it. A file found in none of them raises ``AssetNotFound``, except a model
with a procedural substitute (``assets/procedural.py:SYNTHESIZERS``).

The caches hand back the same objects on every load: ``instantiate_scene``
shares tables between instances by the identity of their ``MeshData``
(``scene/render_scene.py``), so two loads of one file must give the same
meshes for their instances to share one table, as in the reference.
"""
from __future__ import annotations

import logging
import os
import threading
from pathlib import Path

import numpy as np

from ray_tracer_2_tpu_torch.assets import obj as objmod
from ray_tracer_2_tpu_torch.assets.textures import load_image_rgba
from ray_tracer_2_tpu_torch.config import MAX_TEXTURES
from ray_tracer_2_tpu_torch.scene.definition import MeshData
from ray_tracer_2_tpu_torch.scene.material import MaterialFlag, \
    MaterialRecord

log = logging.getLogger(__name__)

#: Default search path; RT2_TPU_ASSETS prepends one.
DEFAULT_ASSET_DIRS = [Path(__file__).resolve().parents[2] / "assets"]


class AssetNotFound(FileNotFoundError):
    pass


class AssetManager:
    def __init__(self, search_dirs: list[os.PathLike] | None = None):
        dirs = [Path(d) for d in (search_dirs or [])]
        env = os.environ.get("RT2_TPU_ASSETS")
        if env:
            dirs.insert(0, Path(env))
        dirs += DEFAULT_ASSET_DIRS
        self.search_dirs = dirs
        self._lock = threading.Lock()
        # path -> slot index (asset.rs:27 loaded_textures)
        self.loaded_textures: dict[str, int] = {}
        # slot -> image (asset.rs:28 cpu_textures)
        self.cpu_textures: dict[int, np.ndarray] = {}
        # (path, object, material) -> MeshData; ("synthetic", path) -> parts
        self.loaded_meshes: dict[tuple, object] = {}

    def resolve(self, rel_path: str) -> Path:
        for d in self.search_dirs:
            p = Path(d) / rel_path
            if p.exists():
                return p
        raise AssetNotFound(
            f"asset {rel_path!r} not found in {[str(d) for d in self.search_dirs]}")

    # ---------------------------------------------------------- textures

    def _claim_slot(self, name: str) -> tuple[int, bool]:
        """(slot of ``name``, whether it was already loaded); slot -1 when
        the 64-slot budget is exhausted (asset.rs:60-85)."""
        with self._lock:
            if name in self.loaded_textures:
                return self.loaded_textures[name], True
            if len(self.loaded_textures) >= MAX_TEXTURES:
                log.warning("Cannot load more than %d textures", MAX_TEXTURES)
                return -1, True
            index = len(self.loaded_textures)
            self.loaded_textures[name] = index
            return index, False

    def load_texture(self, rel_path: str) -> int:
        """Load + cache a texture; returns its atlas slot, or -1 when the
        64-slot budget is exhausted (asset.rs:60-85)."""
        index, done = self._claim_slot(rel_path)
        if done:
            return index
        img = load_image_rgba(self.resolve(rel_path))
        with self._lock:
            self.cpu_textures[index] = img
        return index

    def add_texture(self, name: str, image: np.ndarray) -> int:
        """Register an image made in memory ((H, W, 4) float32 in [0, 1], on
        the u8/255 grid) under ``name``, in the same slot tables as a loaded
        file: a material that names it (``MaterialDefinition.textured``)
        then samples it without a file. Returns its slot (the existing one if
        ``name`` is loaded already), or -1 when the budget is exhausted."""
        index, done = self._claim_slot(name)
        if not done:
            with self._lock:
                self.cpu_textures[index] = np.asarray(image, np.float32)
        return index

    def texture_images(self) -> list[np.ndarray | None]:
        """Dense slot -> image list for atlas building (asset.rs:32-48)."""
        with self._lock:
            return [self.cpu_textures.get(i)
                    for i in range(len(self.loaded_textures))]

    # ------------------------------------------------------------ models

    def load_model(self, rel_path: str, use_mtl: bool,
                   override: MaterialRecord | None = None
                   ) -> list[tuple[MeshData, MaterialRecord, str]]:
        """Load an .obj into (mesh, material, label) sub-meshes.

        With ``use_mtl`` the .mtl materials are converted via
        :func:`material_from_mtl`; otherwise every sub-mesh gets ``override``
        (load_model_with_material, asset.rs:86-100). A file found in no
        search directory but named in ``procedural.SYNTHESIZERS`` is built
        by its synthesizer (once per manager)."""
        try:
            path = self.resolve(rel_path)
        except AssetNotFound:
            from ray_tracer_2_tpu_torch.assets import procedural
            synth = procedural.SYNTHESIZERS.get(rel_path)
            if synth is None:
                raise
            log.warning(
                "asset %s not found in any search path; using the "
                "procedural substitute (assets/procedural.py)", rel_path)
            key = ("synthetic", rel_path)
            with self._lock:
                cached = self.loaded_meshes.get(key)
            if cached is None:
                parts = synth(self)
                with self._lock:
                    self.loaded_meshes[key] = parts
                cached = parts
            if override is not None and not use_mtl:
                return [(mesh, override, label) for mesh, _, label in cached]
            return list(cached)
        models, mtl = objmod.load_obj(path)

        mat_records: dict[str | None, MaterialRecord] = {}
        if use_mtl:
            for name, m in mtl.items():
                diffuse_index = self.load_texture(m.map_kd) if m.map_kd else -1
                normal_index = self.load_texture(m.map_disp) if m.map_disp \
                    else -1
                mat_records[name] = material_from_mtl(m, diffuse_index,
                                                      normal_index)

        out = []
        default = override if override is not None else MaterialRecord()
        for model in models:
            key = (str(path), model.name, model.material)
            with self._lock:
                cached = self.loaded_meshes.get(key)
            if cached is None:
                cached = MeshData.from_vertices(model.positions, model.normals,
                                                model.uvs)
                with self._lock:
                    self.loaded_meshes[key] = cached
            mat = (mat_records.get(model.material, MaterialRecord())
                   if use_mtl else default)
            out.append((cached, mat, model.name))
        return out


def material_from_mtl(m: objmod.MtlMaterial, diffuse_index: int,
                      normal_index: int) -> MaterialRecord:
    """MTL → material conversion, field-for-field asset.rs:141-205:
    illum 4/6/9 ⇒ glass, Ke ⇒ emission (strength = max component, ×2),
    smoothness = sqrt(Ns/100) clamped, specular = max(Ks), ior = Ni."""
    color = m.diffuse if m.diffuse is not None else (0.7, 0.7, 0.7)
    spec = m.specular if m.specular is not None else (1.0, 1.0, 1.0)
    flag = (MaterialFlag.GLASS if (m.illum or 0) in (4, 6, 9)
            else MaterialFlag.DEFAULT)
    if diffuse_index >= 0 or normal_index >= 0:
        flag = MaterialFlag.TEXTURE

    emission_strength = 0.0
    emission_color = (0.0, 0.0, 0.0)
    if m.ke is not None and len(m.ke) == 3:
        emission_strength = max(m.ke)
        denom = emission_strength if emission_strength != 0.0 else 1.0
        emission_color = tuple(v / denom for v in m.ke)

    return MaterialRecord(
        color=(*color, 1.0),
        emission_color=(*emission_color, 1.0),
        specular_color=(*spec, 1.0),
        absorption=(0.0, 0.0, 0.0, 0.0),
        absorption_strength=0.0,
        emission_strength=emission_strength * 2.0,
        smoothness=min(max(((m.shininess or 0.0) / 100.0) ** 0.5, 0.0), 1.0),
        specular=min(max(max(spec), 0.0), 1.0),
        ior=m.optical_density if m.optical_density is not None else 1.0,
        flag=int(flag),
        diffuse_index=diffuse_index,
        normal_index=normal_index,
    )
