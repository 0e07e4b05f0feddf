"""The engine shell against the reference's: the frame protocol of
``RenderParams`` (``update``, ``for_render``, ``pick_motion_scale``) on a
grid of inputs, the camera controller over a seeded input sequence (poses
bit-equal), and ``Engine(device="cpu")`` driven through its frame loop:
frames accumulate, a camera move renders at half resolution with one
bounce and resets the counter, the adaptive ladder, a scene switch, a
missing asset that leaves the engine alive, the debug-mode cycle, the PNG
export, and the first still frame after a move equal to a fresh scene's at
that pose (the camera is rewritten in place, the kernels' copy of it
included)."""
import dataclasses
import itertools
import time

import numpy as np
import PIL.Image
import pytest
import torch

import ray_tracer_2_tpu.config as ref_config
from ray_tracer_2_tpu.scene import camera as ref_camera
from ray_tracer_2_tpu.math.transform import Transform as RefTransform
from ray_tracer_2_tpu_torch import config
from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.engine import Engine, FrameStats
from ray_tracer_2_tpu_torch.engine.export import framebuffer_to_srgb
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels.megakernel import camera_scal, \
    kernel_tables
from ray_tracer_2_tpu_torch.math.transform import Transform
from ray_tracer_2_tpu_torch.scene.camera import Camera, CameraDescriptor
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
from ray_tracer_2_tpu_torch.scene.scenes import SceneName, \
    build_scene_definition
from torch_bridge import host_scene_pair, one_torch_thread  # noqa: F401

W, H = 96, 54


def _values(p) -> dict:
    return {f.name: (int(v) if not isinstance(v, bool) else v)
            for f in dataclasses.fields(p) for v in [getattr(p, f.name)]}


@pytest.mark.parametrize("moving,accumulate,frames,scale", list(
    itertools.product((False, True), (False, True), (-1, 0, 5), (2, 3, 8))))
def test_frame_protocol_matches_reference(moving, accumulate, frames, scale):
    kw = dict(width=200, height=40, bounces=4, rays_per_pixel=3,
              frames=frames, accumulate=accumulate)
    port, ref = RenderParams(**kw), ref_config.RenderParams(**kw)
    (pu, preset), (ru, rreset) = port.update(moving), ref.update(moving)
    assert preset == rreset and _values(pu) == _values(ru)
    assert _values(port.reset_frame()) == _values(ref.reset_frame())
    assert _values(port.for_render(moving, motion_scale=scale)) \
        == _values(ref.for_render(moving, motion_scale=scale))


@pytest.mark.parametrize("last_scale", config.MOTION_LADDER + (5,))
def test_motion_ladder_matches_reference(last_scale):
    assert config.MOTION_LADDER == ref_config.MOTION_LADDER
    for last_s in (None, 0.0, 1e-5, 0.005, 0.015, 0.03, 0.1, 10.0):
        for target in (0.016, 0.033, 0.1):
            assert config.pick_motion_scale(last_scale, last_s, target) \
                == ref_config.pick_motion_scale(last_scale, last_s, target)


def test_controller_matches_reference():
    """A seeded sequence of key presses, mouse moves and scrolls through
    both controllers and ``update_camera``: the same moved flags and the
    same pose, bit for bit."""
    pos, target = [3.0, 1.5, -3.0], [-2.0, -1.0, 2.0]
    port = Camera(CameraDescriptor(transform=Transform.cam(pos, target)))
    ref = ref_camera.Camera(ref_camera.CameraDescriptor(
        transform=RefTransform.cam(pos, target)))
    rng = np.random.default_rng(7)
    keys = list(port.controller.KEY_MAP) + ["q"]
    for _ in range(60):
        dt = float(rng.uniform(0.005, 0.05))
        event = rng.integers(4)
        key = keys[rng.integers(len(keys))]
        pressed = bool(rng.integers(2))
        dx, dy = rng.normal(size=2)
        lines = float(rng.normal())
        for c in (port.controller, ref.controller):
            if event == 0:
                assert c.process_keyboard(key, pressed) == (key != "q")
            elif event == 1:
                c.process_mouse(dx, dy)
            elif event == 2:
                c.process_scroll(lines)
        assert port.update_camera(dt) == ref.update_camera(dt)
        assert port.transform.pos.tobytes() == ref.transform.pos.tobytes()
        assert port.transform.rot.tobytes() == ref.transform.rot.tobytes()
    assert port.controller.speed == 10.0 and port.controller.sensitivity == 1.8


@pytest.mark.parametrize("build", ["room", "sponza"])
def test_camera_moves_match_reference(build):
    """The same seeded moves through both packages' ``HostScene``s: after
    each ``refresh_camera`` the port scene's camera tensors hold the
    reference scene's bytes, and the megakernel's cached camera row, at its
    next lookup, is ``camera_scal`` of them (the same tensor)."""
    from ray_tracer_2_tpu_torch.scene import scenes
    ref, port = host_scene_pair(getattr(scenes, build)())
    tables = kernel_tables(port.scene)
    rng = np.random.default_rng(11)
    for _ in range(6):
        dx, dy = rng.normal(size=2)
        key = ("w", "a", "space", "d")[rng.integers(4)]
        for host in (ref, port):
            host.camera.controller.process_mouse(dx, dy)
            host.camera.controller.process_keyboard(key, True)
            assert host.camera.update_camera(0.05)
            host.camera.controller.process_keyboard(key, False)
            host.refresh_camera()
        rs = ref.render_scene
        for f in ("cam_to_world", "view_params", "defocus_strength",
                  "diverge_strength"):
            assert getattr(port.scene, f).numpy().tobytes() \
                == np.asarray(getattr(rs, f)).tobytes(), f
        assert kernel_tables(port.scene) is tables
        assert torch.equal(tables["scal"], camera_scal(port.scene))


def _engine(scene=SceneName.METAL, **kw):
    return Engine(W, H, initial_scene=scene, block_on_initial_scene=True,
                  device="cpu", **kw)


def test_engine_frames_and_camera_move():
    eng = _engine()
    host = eng.scene_manager.scene
    assert eng.update(dt=0.016, sync=True) is eng.renderer.framebuffer
    for _ in range(2):
        eng.update(dt=0.016)
    assert eng.params.frames == 3
    stats = eng.stats
    assert isinstance(stats, FrameStats) and stats.frame == 3
    assert stats.accumulated_frames == 3 and stats.mrays_per_s > 0.0
    assert stats.bvh_nodes == host.n_nodes
    # a camera move: half resolution, one bounce, the counter reset
    host.camera.controller.process_keyboard("w", True)
    fb = eng.update(dt=0.05)
    moved = eng._last_params
    assert (moved.width, moved.height, moved.bounces) == (W // 2, H // 2, 1)
    assert tuple(fb.shape) == (H // 2, W // 2, 4) and eng.params.frames == -1
    host.camera.controller.process_keyboard("w", False)
    # the first still frame after the move: frame 0 at full size, equal to
    # a fresh scene rendered with the camera at the new pose
    fb = eng.update(dt=0.05, sync=True).clone()
    assert eng.params.frames == 0 and tuple(fb.shape) == (H, W, 4)
    fresh_def = build_scene_definition(SceneName.METAL)
    fresh_def.camera.transform = host.camera.transform.copy()
    fresh = instantiate_scene(fresh_def)
    want = Renderer(device="cpu").render(fresh, dataclasses.replace(
        eng.params, frames=0))
    assert torch.equal(fb, want)
    assert torch.equal(host.scene.cam_to_world, fresh.cam_to_world)


def test_camera_refresh_rewrites_the_kernels_copy():
    """``refresh_camera`` writes the new pose into the scene's tensors and
    into the megakernel's cached camera row in place: the same tensors,
    the fresh scene's values."""
    eng = _engine(SceneName.ROOM)
    host = eng.scene_manager.scene
    scal = kernel_tables(host.scene)["scal"]
    ptr = scal.data_ptr()
    host.camera.controller.process_mouse(0.3, -0.2)
    eng.update(dt=0.1)
    fresh_def = build_scene_definition(SceneName.ROOM)
    fresh_def.camera.transform = host.camera.transform.copy()
    fresh = instantiate_scene(fresh_def)
    tab = kernel_tables(host.scene)
    assert tab["scal"].data_ptr() == ptr
    assert torch.equal(tab["scal"], camera_scal(fresh))
    assert torch.equal(tab["scal"], kernel_tables(fresh)["scal"])


def test_adaptive_motion_ladder():
    """With ``adaptive_motion`` the moving frames' downscale follows the
    measured moving-frame time (reference ``test_adaptive_motion``)."""
    eng = Engine(192, 108, initial_scene=SceneName.METAL,
                 block_on_initial_scene=True, device="cpu")
    eng.params = dataclasses.replace(eng.params, adaptive_motion=True,
                                     bounces=2)
    eng.update(dt=0.016, is_moving=True, sync=True)
    assert eng._last_params.width == 192 // 2
    eng._last_render_s = 0.200   # 200 ms at scale 2: scale 6 fits 33 ms
    eng.update(dt=0.016, is_moving=True, sync=True)
    assert eng._last_params.width == 192 // 6
    assert eng._last_params.bounces == 1
    eng._last_render_s = 0.0001  # instant: refine to the ladder's start
    eng.update(dt=0.016, is_moving=True, sync=True)
    assert eng._last_params.width == 192 // 2
    eng.update(dt=0.016, sync=True)
    assert eng._last_params.width == 192


def test_scene_switch_missing_asset_and_actions(tmp_path):
    """A scene switch loads in the background and resets accumulation; a
    scene whose file is missing (CornellBox) logs its ``AssetNotFound``
    and keeps the engine rendering the current scene; E cycles the debug
    modes (the debug frame renders through the plain debug path); P
    writes the PNG of the framebuffer."""
    eng = _engine()
    eng.update(dt=0.016)
    eng.scene_manager.request_scene(SceneName.ROOM)
    deadline = time.time() + 60
    while eng.scene_manager.selected_scene == SceneName.ROOM \
            and eng.scene_manager.scene.n_triangles == 0:
        eng.update(dt=0.016)
        assert time.time() < deadline
    assert eng.params.frames == 0      # reset on arrival, then one frame
    assert eng.scene_manager.scene.n_triangles == 12
    room = eng.scene_manager.scene
    eng.scene_manager.request_scene(SceneName.CORNELL_BOX)
    time.sleep(0.5)
    for _ in range(3):
        assert eng.update(dt=0.016) is not None
    assert eng.scene_manager.scene is room
    for mode in range(1, 8):
        eng.cycle_debug_mode()
        assert eng.params.debug_mode == DebugMode(mode)
        assert eng.params.frames == -1
        eng.update(dt=0.016, sync=True)
        assert int(eng.renderer.last_segments) == 0
    eng.cycle_debug_mode()
    assert eng.params.debug_mode == DebugMode.OFF
    eng.update(dt=0.016, sync=True)
    eng.save_render(tmp_path / "out.png")
    png = np.asarray(PIL.Image.open(tmp_path / "out.png"))
    assert np.array_equal(png, framebuffer_to_srgb(
        eng.renderer.read_framebuffer()))
    eng.toggle_low_res()
    assert (eng.params.width, eng.params.height) == (W // 2, H // 2)
    eng.toggle_low_res()
    eng.toggle_skybox()
    assert not eng.params.skybox
    eng.toggle_accumulate()
    eng.update(dt=0.016)
    assert eng.params.frames == -1     # accumulation off: every frame fresh
    eng.rebuild_bvh("low")
    assert eng.scene_manager.bvh_quality.value == "low"
    eng.scene_manager.shutdown()
