"""Render-state checkpointing (port of
``ray_tracer_2_tpu/engine/checkpoint.py``; SURVEY.md section 5.4).

The progressive render's whole state is the accumulation framebuffer, the
render parameters (the frame counter among them), the camera pose and the
scene's name, written to one ``.npz`` in the reference's layout, array for
array: ``framebuffer``, ``meta`` (the JSON of ``params`` and
``scene_name`` as uint8 bytes) and, with a camera, ``camera_pos``,
``camera_rot``, ``camera_fov``, ``camera_focus``. So a checkpoint written
by either package loads in the other. A restored render continues the RNG
stream exactly: every draw is a counter hash of (pixel, frame) (rng.py).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams


def save_checkpoint(path, framebuffer, params: RenderParams, *,
                    scene_name: str | None = None, camera=None) -> None:
    """``framebuffer``: (H, W, 4) float32, a tensor on any device or an
    array; ``camera``: a scene ``Camera``."""
    meta = dict(
        params={f.name: (int(getattr(params, f.name))
                         if not isinstance(getattr(params, f.name), bool)
                         else bool(getattr(params, f.name)))
                for f in dataclasses.fields(params)},
        scene_name=scene_name,
    )
    if isinstance(framebuffer, torch.Tensor):
        framebuffer = framebuffer.detach().cpu().numpy()
    arrays = dict(framebuffer=np.asarray(framebuffer),
                  meta=np.frombuffer(json.dumps(meta).encode(),
                                     dtype=np.uint8))
    if camera is not None:
        arrays["camera_pos"] = np.asarray(camera.transform.pos, np.float32)
        arrays["camera_rot"] = np.asarray(camera.transform.rot, np.float32)
        arrays["camera_fov"] = np.float32(camera.fov)
        arrays["camera_focus"] = np.float32(camera.focus_dist)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path) -> dict:
    """dict(framebuffer (numpy), params, scene_name, camera_pose or
    None)."""
    with np.load(path) as z:
        fb = z["framebuffer"]
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        p = meta["params"]
        p["debug_mode"] = DebugMode(p.get("debug_mode", 0))
        out = dict(framebuffer=fb, params=RenderParams(**p),
                   scene_name=meta.get("scene_name"), camera_pose=None)
        if "camera_pos" in z:
            out["camera_pose"] = dict(
                pos=z["camera_pos"], rot=z["camera_rot"],
                fov=float(z["camera_fov"]),
                focus_dist=float(z["camera_focus"]))
    return out


def restore_engine(engine, path) -> None:
    """Resume a progressive render in an ``Engine``: the framebuffer, on
    the renderer's device, the parameters with their frame counter, and
    the camera pose of the loaded scene."""
    ckpt = load_checkpoint(path)
    engine.params = ckpt["params"]
    engine.renderer.ensure_framebuffer(ckpt["params"].width,
                                       ckpt["params"].height)
    engine.renderer.framebuffer.copy_(torch.from_numpy(ckpt["framebuffer"]))
    pose = ckpt["camera_pose"]
    host = engine.scene_manager.scene
    if pose is not None and host is not None:
        host.camera.transform.pos = np.asarray(pose["pos"], np.float32)
        host.camera.transform.rot = np.asarray(pose["rot"], np.float32)
        host.camera.fov = pose["fov"]
        host.camera.focus_dist = pose["focus_dist"]
        host.refresh_camera()
