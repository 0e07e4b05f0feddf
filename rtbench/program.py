"""The system under test, ``ray_tracer_2_tpu_torch``, as the benchmark
drives it: a configuration's inputs handed over as the program's scene
definition and textures, and the ``Engine`` that renders it. The only
module a run imports the program through (``calibrate``, run once by hand,
also reads the megakernel's counters)."""
from __future__ import annotations

import numpy as np


def scene_definition(inputs: dict):
    """(``SceneDefinition``, ``AssetManager``) of a configuration's inputs:
    every mesh an entity under its transform, every sphere one, the
    images registered as textures under their names (u8 bytes over 255)."""
    from ray_tracer_2_tpu_torch.assets.manager import AssetManager
    from ray_tracer_2_tpu_torch.math.transform import (
        Transform, quat_from_axis_angle,
    )
    from ray_tracer_2_tpu_torch.scene.camera import CameraDescriptor
    from ray_tracer_2_tpu_torch.scene.definition import (
        MeshData, MeshFromData, SceneDefinition,
    )
    from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition

    assets = AssetManager()
    for name, img in inputs.get("images", {}).items():
        assets.add_texture(name, img.astype(np.float32) / np.float32(255.0))

    def material(m: dict):
        fields = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in m.items() if k != "texture"}
        return MaterialDefinition(**fields, diffuse_texture=m.get("texture"))

    def transform(t: dict):
        return Transform(pos=t["pos"],
                         rot=quat_from_axis_angle(t["axis"], t["angle"]),
                         scale=t["scale"])

    cam = inputs["camera"]
    s = SceneDefinition()
    s.set_camera(CameraDescriptor(
        transform=Transform.cam(cam["pos"], cam["target"]), fov=cam["fov"],
        aspect=cam["aspect"], focus_dist=cam["focus_dist"],
        defocus_strength=cam["defocus_strength"],
        diverge_strength=cam["diverge_strength"]))
    for mesh in inputs["meshes"]:
        s.add_mesh(transform(mesh["transform"]),
                   MeshFromData(MeshData.from_vertices(mesh["pos"],
                                                       mesh["nrm"],
                                                       mesh["uv"])),
                   material(mesh["material"]))
    for sph in inputs["spheres"]:
        s.add_sphere(sph["centre"], sph["radius"], material(sph["material"]))
    return s, assets


def engine(inputs: dict, device: str, params: dict):
    """An ``Engine`` on ``device`` whose ``RenderParams`` are the README's
    defaults (5 bounces, 1 ray a pixel, skybox on, no NEE, antialias or
    normal maps) with ``params`` set over them (``width`` and ``height``
    among them), its scene the configuration's, handed over as
    ``SceneManager.poll_loaded`` does: instantiated, moved to the device
    once, accumulation reset."""
    import dataclasses

    from ray_tracer_2_tpu_torch.engine.engine import Engine
    from ray_tracer_2_tpu_torch.scene.render_scene import \
        instantiate_host_scene

    rest = dict(params)
    eng = Engine(width=rest.pop("width"), height=rest.pop("height"),
                 initial_scene=None, device=device)
    eng.params = dataclasses.replace(eng.params, **rest)
    definition, assets = scene_definition(inputs)
    eng.scene_manager.scene = instantiate_host_scene(definition, assets) \
        .to(eng.device)
    eng.params = eng.params.reset_frame()
    return eng
