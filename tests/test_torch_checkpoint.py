"""Checkpoint and resume (``engine/checkpoint.py``): a restored render
continues the exact RNG stream, so N frames straight equal k frames, a
checkpoint, a restore and N - k frames, bit for bit (the reference's
``tests/test_checkpoint.py`` on the port); the camera pose survives the
round trip; and the file is the reference's layout, array for array, so a
checkpoint written by either package loads in the other with equal
parameters and framebuffer bytes."""
import dataclasses

import numpy as np
import torch

from ray_tracer_2_tpu.config import RenderParams as RefParams
from ray_tracer_2_tpu.engine.checkpoint import (
    load_checkpoint as ref_load, save_checkpoint as ref_save,
)
from ray_tracer_2_tpu.scene import scenes as ref_scenes
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.engine import Engine
from ray_tracer_2_tpu_torch.engine.checkpoint import (
    load_checkpoint, restore_engine, save_checkpoint,
)
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_host_scene
from ray_tracer_2_tpu_torch.scene.scenes import SceneName
from torch_bridge import one_torch_thread  # noqa: F401

P = RenderParams(width=24, height=16, bounces=2, rays_per_pixel=1,
                 skybox=True)


def test_resume_bitexact(tmp_path):
    host = instantiate_host_scene(scenes.metal())
    r1 = Renderer(device="cpu")
    for f in range(6):
        straight = r1.render(host.scene, dataclasses.replace(P, frames=f))
    r2 = Renderer(device="cpu")
    for f in range(3):
        fb = r2.render(host.scene, dataclasses.replace(P, frames=f))
    ck = tmp_path / "state.npz"
    save_checkpoint(ck, fb, dataclasses.replace(P, frames=2),
                    scene_name="Metal", camera=host.camera)
    loaded = load_checkpoint(ck)
    assert loaded["params"] == dataclasses.replace(P, frames=2)
    assert loaded["scene_name"] == "Metal"
    r3 = Renderer(device="cpu")
    r3.ensure_framebuffer(P.width, P.height)
    r3.framebuffer.copy_(torch.from_numpy(loaded["framebuffer"]))
    for f in range(3, 6):
        resumed = r3.render(host.scene, dataclasses.replace(P, frames=f))
    assert torch.equal(straight, resumed)


def test_camera_pose_roundtrip(tmp_path):
    host = instantiate_host_scene(scenes.metal())
    host.camera.transform.pos = np.array([1.0, 2.0, 3.0], np.float32)
    host.camera.fov = 33.0
    save_checkpoint(tmp_path / "c.npz", np.zeros((8, 8, 4), np.float32),
                    RenderParams(width=8, height=8), camera=host.camera)
    pose = load_checkpoint(tmp_path / "c.npz")["camera_pose"]
    np.testing.assert_array_equal(pose["pos"], [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(pose["rot"], host.camera.transform.rot)
    assert pose["fov"] == 33.0 and pose["focus_dist"] == host.camera.focus_dist


def _fields(params) -> dict:
    """A RenderParams of either package as plain values."""
    return {f.name: (int(v) if not isinstance(v, bool) else v)
            for f in dataclasses.fields(params)
            for v in [getattr(params, f.name)]}


def test_checkpoints_cross_packages(tmp_path):
    """A port checkpoint loads in the JAX package and a JAX one in the
    port: equal parameters (every field, debug mode and motion fields
    included), scene name, pose and framebuffer bytes."""
    rng = np.random.default_rng(3)
    fb = rng.random((16, 24, 4)).astype(np.float32)
    port_p = dataclasses.replace(P, frames=7, debug_mode=DebugMode.DEPTH,
                                 debug_scale=40, nee=True,
                                 adaptive_motion=True, motion_target_ms=20)
    host = instantiate_host_scene(scenes.room())
    save_checkpoint(tmp_path / "port.npz", torch.from_numpy(fb), port_p,
                    scene_name="room", camera=host.camera)
    got = ref_load(tmp_path / "port.npz")
    assert _fields(got["params"]) == _fields(port_p)
    assert got["framebuffer"].tobytes() == fb.tobytes()
    assert got["scene_name"] == "room"
    np.testing.assert_array_equal(got["camera_pose"]["pos"],
                                  host.camera.transform.pos)

    ref_host = ref_instantiate(ref_scenes.room())
    ref_p = RefParams(**{**_fields(port_p), "frames": 11,
                         "debug_mode": port_p.debug_mode})
    ref_save(tmp_path / "ref.npz", fb[::-1].copy(), ref_p,
             scene_name="room", camera=ref_host.camera)
    back = load_checkpoint(tmp_path / "ref.npz")
    assert _fields(back["params"]) == _fields(ref_p)
    assert isinstance(back["params"], RenderParams)
    assert back["framebuffer"].tobytes() == fb[::-1].tobytes()
    np.testing.assert_array_equal(back["camera_pose"]["rot"],
                                  ref_host.camera.transform.rot)


def test_restore_engine(tmp_path):
    """``restore_engine`` puts the framebuffer on the renderer's device,
    the parameters with their frame counter, and the camera pose on the
    loaded scene (its tensors follow)."""
    eng = Engine(24, 16, initial_scene=SceneName.METAL,
                 block_on_initial_scene=True, device="cpu")
    host = eng.scene_manager.scene
    fb = np.random.default_rng(5).random((16, 24, 4)).astype(np.float32)
    cam = instantiate_host_scene(scenes.metal()).camera
    cam.transform.pos = np.array([0.5, 1.0, 4.0], np.float32)
    save_checkpoint(tmp_path / "e.npz", fb, dataclasses.replace(P, frames=4),
                    camera=cam)
    restore_engine(eng, tmp_path / "e.npz")
    assert eng.params.frames == 4
    assert eng.renderer.framebuffer.device == eng.device
    assert eng.renderer.read_framebuffer().tobytes() == fb.tobytes()
    np.testing.assert_array_equal(host.scene.cam_to_world[:3, 3].numpy(),
                                  [0.5, 1.0, 4.0])
