"""Sponza at the real model's scale: the procedural atrium at detail 10,
each part textured with a seeded 1024 x 1024 image, under sponza's camera,
quad light and emissive sphere (``sponza268k.json``)."""
from __future__ import annotations

import numpy as np

from rtbench.frozen.atrium import build_atrium
from rtbench.frozen.images import seeded_image_u8

#: the unit XY quad (the port's ``MeshData.quad``) as two triangles,
#: indices 0 1 2, 0 2 3: positions, normals and UVs per corner
_QUAD = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0],
                  [-1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
_QUAD_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]],
                    np.float32)


def inputs(spec: dict, seed: int) -> dict:
    """The scene; it does not depend on ``seed``."""
    a = spec["atrium"]
    meshes, images = [], {}
    for k, (name, pos, nrm, uv) in enumerate(build_atrium(a["detail"])):
        images[name] = seeded_image_u8(a["image_size"], a["image_seed"] + k)
        meshes.append(dict(transform=spec["atrium_transform"], pos=pos,
                           nrm=nrm, uv=uv,
                           material=dict(spec["part_material"], texture=name)))
    light = spec["light"]
    meshes.append(dict(transform=light["transform"], pos=_QUAD,
                       nrm=np.tile(np.array([[0, 0, 1]], np.float32), (6, 1)),
                       uv=_QUAD_UV, material=light["material"]))
    return dict(camera=dict(spec["camera"]), meshes=meshes,
                spheres=[dict(spec["sphere"])], images=images)
