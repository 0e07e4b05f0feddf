"""Wavefront OBJ/MTL parsing into SoA numpy arrays (a copy of
``ray_tracer_2_tpu/assets/obj.py``, which is pure numpy, kept statement for
statement so both parse a file into the same arrays).

Reproduces the loading semantics the reference gets from ``tobj`` +
``asset.rs``: fan triangulation (asset.rs:112 ``triangulate: true``),
independent position/uv/normal index streams (``single_index: false``),
area-weighted vertex normals when the file has none (asset.rs:224-261), and
de-indexing into flat triangle soup (asset.rs:262-310). Sub-meshes are split
per (object/group, active material) so each carries one material id.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class ObjModel:
    name: str
    material: str | None     # mtl material name, None if no usemtl
    positions: np.ndarray    # (V, 3) de-indexed triangle soup (V = 3*T)
    normals: np.ndarray      # (V, 3)
    uvs: np.ndarray          # (V, 2)


@dataclasses.dataclass
class MtlMaterial:
    """Raw .mtl fields used by the reference (asset.rs:141-205)."""

    name: str
    diffuse: tuple | None = None          # Kd
    specular: tuple | None = None         # Ks
    shininess: float | None = None        # Ns
    optical_density: float | None = None  # Ni
    illum: int | None = None
    ke: tuple | None = None               # Ke
    map_kd: str | None = None
    map_disp: str | None = None


def _floats(parts, n):
    vals = [float(p) for p in parts[:n]]
    return tuple(vals) if len(vals) == n else None


def load_mtl(path: Path) -> dict[str, MtlMaterial]:
    materials: dict[str, MtlMaterial] = {}
    cur: MtlMaterial | None = None
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0]
            args = parts[1:]
            if key == "newmtl" and args:
                cur = MtlMaterial(name=args[0])
                materials[args[0]] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur.diffuse = _floats(args, 3)
            elif key == "Ks":
                cur.specular = _floats(args, 3)
            elif key == "Ns":
                cur.shininess = float(args[0])
            elif key == "Ni":
                cur.optical_density = float(args[0])
            elif key == "illum":
                cur.illum = int(float(args[0]))
            elif key == "Ke":
                cur.ke = _floats(args, 3)
            elif key == "map_Kd":
                cur.map_kd = args[-1]
            elif key == "map_Disp":
                cur.map_disp = args[-1]
    return materials


def load_obj(path: Path) -> tuple[list[ObjModel], dict[str, MtlMaterial]]:
    """Parse an .obj (+ any referenced .mtl) into de-indexed sub-meshes.

    The tokenize phase runs in the native C++ parser when available
    (assets/native/obj_parser.cpp — the analog of the reference's tobj
    crate, asset.rs:110-118); the Python parser below is the fallback where
    g++ cannot build it. Both feed the same numpy de-index/normal-generation
    assembly."""
    path = Path(path)
    try:
        from ray_tracer_2_tpu_torch.assets.native import parse_obj_native
        native = parse_obj_native(path)
    except Exception:
        native = None
    if native is not None:
        pos, uv, nrm, groups, mtllibs = native
        materials: dict[str, MtlMaterial] = {}
        for m in mtllibs:
            mtl_path = path.parent / m
            if mtl_path.exists():
                materials.update(load_mtl(mtl_path))
        return _assemble(pos, uv, nrm, groups), materials

    pos, uv, nrm, groups, materials = _parse_obj_python(path)
    return _assemble(pos, uv, nrm, groups), materials


def _parse_obj_python(path: Path):
    positions: list[tuple] = []
    uvs: list[tuple] = []
    normals: list[tuple] = []
    materials: dict[str, MtlMaterial] = {}

    # Faces grouped by (object_name, material_name): list of corner triples.
    groups: dict[tuple[str, str | None], list] = {}
    cur_obj = ""
    cur_mtl: str | None = None

    def corner(tok: str):
        """'v', 'v/t', 'v//n', 'v/t/n'. 1-based indices; negative indices are
        relative to the stream length *at parse time*. Resolved immediately to
        0-based (-1 = absent)."""
        s = tok.split("/")
        vi = int(s[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ni = -1
        if len(s) > 1 and s[1]:
            t = int(s[1])
            ti = t - 1 if t > 0 else len(uvs) + t
        if len(s) > 2 and s[2]:
            n = int(s[2])
            ni = n - 1 if n > 0 else len(normals) + n
        return (vi, ti, ni)

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif key == "vt":
                uvs.append(tuple(float(x) for x in parts[1:3]))
            elif key == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif key == "f":
                corners = [corner(t) for t in parts[1:]]
                tris = groups.setdefault((cur_obj, cur_mtl), [])
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tris.append((corners[0], corners[k], corners[k + 1]))
            elif key in ("o", "g"):
                cur_obj = " ".join(parts[1:]) if len(parts) > 1 else ""
            elif key == "usemtl":
                cur_mtl = parts[1] if len(parts) > 1 else None
            elif key == "mtllib" and len(parts) > 1:
                mtl_path = path.parent / " ".join(parts[1:])
                if mtl_path.exists():
                    materials.update(load_mtl(mtl_path))

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    uv = (np.asarray(uvs, np.float32).reshape(-1, 2)
          if uvs else np.zeros((0, 2), np.float32))
    nrm = (np.asarray(normals, np.float32).reshape(-1, 3)
           if normals else np.zeros((0, 3), np.float32))
    idx_groups = {k: np.asarray(v, np.int64) for k, v in groups.items() if v}
    return pos, uv, nrm, idx_groups, materials


def _assemble(pos, uv, nrm, groups) -> list[ObjModel]:
    """De-index parsed streams into flat triangle-soup sub-meshes
    (asset.rs:262-310 semantics), generating area-weighted normals when the
    file has none (asset.rs:224-261)."""
    models: list[ObjModel] = []
    computed_normals: np.ndarray | None = None

    for (obj_name, mtl_name), tris in groups.items():
        idx = np.asarray(tris, np.int64)  # (T, 3 corners, 3 streams), 0-based
        v_idx = idx[:, :, 0]
        t_idx = idx[:, :, 1]
        n_idx = idx[:, :, 2]

        soup_pos = pos[v_idx.reshape(-1)]

        if len(nrm) and (n_idx >= 0).all():
            soup_nrm = nrm[n_idx.reshape(-1)]
        elif len(nrm):
            # Normals exist but some corners lack indices: positional fallback
            # (asset.rs:284-291).
            soup_nrm = nrm[np.clip(v_idx.reshape(-1), 0, len(nrm) - 1)]
        else:
            if computed_normals is None:
                computed_normals = _area_weighted_normals(pos, groups)
            soup_nrm = computed_normals[v_idx.reshape(-1)]

        if len(uv) and (t_idx >= 0).all():
            soup_uv = uv[t_idx.reshape(-1)]
        else:
            soup_uv = np.zeros((len(soup_pos), 2), np.float32)

        models.append(ObjModel(
            name=obj_name, material=mtl_name,
            positions=soup_pos.astype(np.float32),
            normals=soup_nrm.astype(np.float32),
            uvs=soup_uv.astype(np.float32),
        ))

    return models


def _area_weighted_normals(pos: np.ndarray, groups: dict) -> np.ndarray:
    """Accumulate cross(e1, e2) per shared position index, then normalize —
    the magnitude-weighted scheme of asset.rs:224-261."""
    acc = np.zeros_like(pos, dtype=np.float64)
    for tris in groups.values():
        idx = np.asarray(tris, np.int64)[:, :, 0]  # already 0-based
        v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
        n = np.cross(v1 - v0, v2 - v1)
        np.add.at(acc, idx[:, 0], n)
        np.add.at(acc, idx[:, 1], n)
        np.add.at(acc, idx[:, 2], n)
    lens = np.linalg.norm(acc, axis=1, keepdims=True)
    return (acc / np.where(lens > 0.0, lens, 1.0)).astype(np.float32)
