"""What runs over a mesh besides the frame functions
(``tests/test_torch_sharding.py`` holds those against the JAX package):
scene copies that follow live edits and camera moves, a height the mesh
does not divide, and the entry points on an explicit mesh of CPU devices
(``Engine`` with a checkpoint and a resume, the CLI through ``Renderer``'s
default mesh, ``render_batch``, the viewer's readback), and the debug
path's row window.

Row tiles render through the same plain versions as a single-device
frame, so the segments are exact and the pixels bit-equal at
``bounces=0`` and in the debug modes; at ``bounces>0`` within
``ULP_TOL`` (an ulp of the CPU's SIMD/scalar rounding by a pixel's place
in a batch; see ``tests/test_torch_sharding.py``). A resumed or batched
sharded render is bit-equal to a straight one on the same mesh: the same
windows, the same order.
"""
import dataclasses
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tracer_2_tpu_torch.parallel.sharding as sharding
from ray_tracer_2_tpu_torch.__main__ import main
from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.engine import Engine
from ray_tracer_2_tpu_torch.engine.checkpoint import (
    load_checkpoint, restore_engine, save_checkpoint,
)
from ray_tracer_2_tpu_torch.engine.export import framebuffer_to_srgb
from ray_tracer_2_tpu_torch.engine.renderer import Renderer, render_frame
from ray_tracer_2_tpu_torch.kernels import spheres
from ray_tracer_2_tpu_torch.kernels.debug import render_debug
from ray_tracer_2_tpu_torch.kernels.megakernel import kernel_tables, \
    light_tables
from ray_tracer_2_tpu_torch.parallel.sharding import (
    ShardedFramebuffer, make_render_mesh, render_frame_sharded,
    shard_framebuffer,
)
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import (
    TENSORS, instantiate_host_scene, instantiate_scene,
)
from ray_tracer_2_tpu_torch.scene.scenes import SceneName
from ray_tracer_2_tpu_torch.viewer.server import ViewerServer
from test_torch_viewer import _decode_png, _wait_frame
from torch_bridge import (
    EDIT_CASES, CopyingReplicas, apply_edits, scene_builder,
)
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

ULP_TOL = 1e-6
W, H = 24, 16


def cpu_mesh(n):
    return make_render_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("case", ["metal_sphere", "random_balls_sphere_bvh",
                                  "wide_glass", "wide_colour",
                                  "quad_instance_partial", "room_lights"])
def test_replica_follows_edits_and_camera_moves(case):
    """Copies of a scene (forced even on the CPU: ``CopyingReplicas``) on
    which a frame built the kernels' tables follow each live edit and a
    camera move after it: every tensor equal to the source's, and the
    sharded frame bit-equal (bounces 0) to the edited scene's own frame,
    with and without antialias (the megakernel's tables and the
    small-scene path's)."""
    build, port_kw, edits, options = EDIT_CASES[case]
    host = instantiate_host_scene(scene_builder(build)(), **port_kw)
    mesh = cpu_mesh(2)
    reps = CopyingReplicas(host.scene, mesh.distinct)
    w, h = 24, 16
    kw = dict(width=w, height=h, bounces=0, rays_per_pixel=1, skybox=True,
              **options)

    def check(label):
        reps.follow(host.scene)
        copy = reps.on(torch.device("cpu"))
        assert copy is not host.scene
        for f in TENSORS:
            assert torch.equal(getattr(copy, f), getattr(host.scene, f)), \
                (label, f)
        # the kernels' tables (the CUDA kernels read them; the plain
        # versions read the scene): kept, written or dropped and rebuilt,
        # each copy's equal to the source's
        for sc in (host.scene, copy):
            kernel_tables(sc)
            if sc.lights:
                light_tables(sc)
            if spheres.eligible(sc):
                spheres.pack_tables(sc)
        _same_tables(copy.derived, host.scene.derived, label)
        for aa in (False, True):
            fb = shard_framebuffer(torch.zeros((h, w, 4)), mesh)
            got, segs = render_frame_sharded(reps, fb, 1, mesh=mesh,
                                             antialias=aa, **kw)
            want, wsegs = render_frame(host.scene, torch.zeros((h, w, 4)), 1,
                                       antialias=aa, **kw)
            assert int(segs) == int(wsegs), (label, aa)
            assert np.asarray(got).tobytes() == want.numpy().tobytes(), \
                (label, aa)

    check("before")
    for i, edit in enumerate(edits):
        apply_edits(host, [edit])
        check(f"edit {i}")
        host.camera.transform.pos = host.camera.transform.pos \
            + np.float32(0.05 * (i + 1))
        host.refresh_camera()
        check(f"camera after edit {i}")


def _same_tables(got: dict, want: dict, label) -> None:
    assert set(got) == set(want), label
    for k, v in want.items():
        g = got[k]
        if isinstance(v, torch.Tensor):
            assert torch.equal(g, v), (label, k)
        elif isinstance(v, dict):
            _same_tables(g, v, (label, k))
        elif dataclasses.is_dataclass(v):
            _same_tables(vars(g), vars(v), (label, k))
        else:
            assert g == v, (label, k)


def test_a_replaced_scene_keeps_shared_copies():
    """A glass toggle puts a new ``TorchScene`` in the host (new material
    classes) that shares its tensors with the old: the copies keep theirs
    and copy only what was written; an unrelated scene is copied whole."""
    host = instantiate_host_scene(scenes.wide_bvh_scene())
    reps = CopyingReplicas(host.scene, cpu_mesh(2).distinct)
    cpu = torch.device("cpu")
    before = reps.on(cpu)
    host.edit_material(0, flag=1, ior=1.5)
    assert host.scene.shade_classes != before.shade_classes
    after = reps.follow(host.scene).on(cpu)
    assert after.shade_classes == host.scene.shade_classes
    assert after.tri_attr is before.tri_attr
    assert torch.equal(after.wide_rows, host.scene.wide_rows)
    other = instantiate_scene(scenes.metal())
    fresh = reps.follow(other).on(cpu)
    assert fresh.tri_attr is not before.tri_attr
    assert fresh.n_spheres == other.n_spheres


def test_engine_keeps_its_copies_while_the_mesh_changes(monkeypatch):
    """The default mesh changes with the frame's height: 36 rows take 4
    devices, the moving frame's 18 take 3 (as 540 and 270 rows on four
    cards). The engine makes its scene copies once, at its first frame,
    and renders from them through a move and a stop: only the camera's
    fields are written into them, their derived tables are kept, and they
    equal the source."""
    def auto(height, device):
        n = 4
        while height % n:
            n -= 1
        return cpu_mesh(n)

    real_copy = sharding._copy_scene
    copies = []

    def counted_copy(scene, dev):
        copies.append(dev)
        return real_copy(scene, dev)

    monkeypatch.setattr(sharding, "auto_mesh", auto)
    monkeypatch.setattr(sharding, "_copy_scene", counted_copy)
    monkeypatch.setattr(sharding, "replicate_scene",
                        lambda sc, mesh: CopyingReplicas(sc, mesh.distinct))
    eng = Engine(W, 36, initial_scene=SceneName.METAL,
                 block_on_initial_scene=True, device="cpu")
    host = eng.scene_manager.scene
    cpu = torch.device("cpu")
    eng.update(dt=0.016, sync=True)
    assert eng.renderer.mesh.rows == 4 and len(copies) == 1
    reps = eng.renderer._replicas
    copy = reps.on(cpu)
    tensors = {f: getattr(copy, f) for f in TENSORS}
    derived = dict(copy.derived)
    assert copy is not host.scene and derived
    seen = reps.seen
    host.camera.controller.process_keyboard("w", True)
    for _ in range(2):
        eng.update(dt=0.05, sync=True)
        assert eng.renderer.mesh.rows == 3
        assert eng._last_params.height == 18
    host.camera.controller.process_keyboard("w", False)
    eng.update(dt=0.016, sync=True)
    assert eng.renderer.mesh.rows == 4
    assert len(copies) == 1 and eng.renderer._replicas is reps
    assert reps.on(cpu) is copy
    written = host.scene.writes.since(seen)
    assert written == {"camera", "cam_to_world", "view_params",
                       "defocus_strength", "diverge_strength"}
    for f in TENSORS:
        assert getattr(copy, f) is tensors[f], f
        assert torch.equal(getattr(copy, f), getattr(host.scene, f)), f
    assert all(copy.derived.get(k) is v for k, v in derived.items())
    eng.scene_manager.shutdown()


def test_non_dividing_height_raises():
    """No fallback to one device: a height the mesh's rows do not divide
    raises, in the frame functions and in ``Renderer``; so does a mesh
    whose home is not the renderer's device, or a 2-D mesh there."""
    ts = instantiate_scene(scenes.metal())
    mesh = cpu_mesh(3)
    with pytest.raises(ValueError, match="divisible"):
        shard_framebuffer(torch.zeros((16, 8, 4)), mesh)
    fb = shard_framebuffer(torch.zeros((15, 8, 4)), mesh)
    with pytest.raises(ValueError, match="divisible"):
        render_frame_sharded(ts, fb, 0, mesh=mesh, width=8, height=16,
                             bounces=0, rays_per_pixel=1, skybox=True)
    p = RenderParams(width=8, height=16, bounces=0)
    with pytest.raises(ValueError, match="divisible"):
        Renderer(device="cpu", mesh=mesh).render(ts, p)
    with pytest.raises(ValueError):
        Renderer(device="cpu",
                 mesh=sharding.make_render_mesh2d(2, 2, ["cpu"] * 4))
    with pytest.raises(ValueError):
        make_render_mesh(5, ["cpu"] * 4)


def _engine(mesh, **kw):
    return Engine(W, H, initial_scene=SceneName.METAL,
                  block_on_initial_scene=True, device="cpu", mesh=mesh, **kw)


def test_engine_checkpoint_resume_on_a_mesh(tmp_path):
    """``Engine`` on a mesh of 4: a camera move (its half-size frame on the
    same mesh), then still frames; checkpointed after three, restored into
    a new engine's row blocks and resumed: bit-equal to the straight run.
    Its first still frame matches the single-device engine's."""
    straight = _engine(cpu_mesh(4))
    single = _engine(None)
    host = straight.scene_manager.scene
    for eng in (straight, single):
        eng.update(dt=0.016, sync=True)
    assert isinstance(straight.renderer.framebuffer, ShardedFramebuffer)
    np.testing.assert_allclose(straight.renderer.read_framebuffer(),
                               single.renderer.read_framebuffer(), rtol=0,
                               atol=ULP_TOL)
    assert int(straight.renderer.last_segments) \
        == int(single.renderer.last_segments)
    host.camera.controller.process_keyboard("w", True)
    moving = straight.update(dt=0.05, sync=True)
    host.camera.controller.process_keyboard("w", False)
    mp = straight._last_params
    assert mp.bounces == 1 and (mp.width, mp.height) != (W, H)
    assert tuple(moving.shape) == (mp.height, mp.width, 4)
    assert len(moving.blocks) == 4
    for _ in range(3):
        straight.update(dt=0.016)
    ck = tmp_path / "mesh.npz"
    save_checkpoint(ck, straight.renderer.framebuffer, straight.params,
                    scene_name="Metal", camera=host.camera)
    assert load_checkpoint(ck)["framebuffer"].tobytes() \
        == straight.renderer.read_framebuffer().tobytes()
    for _ in range(3):
        straight.update(dt=0.016, sync=True)
    resumed = _engine(cpu_mesh(4))
    restore_engine(resumed, ck)
    blocks = resumed.renderer.framebuffer.blocks
    assert len(blocks) == 4 and all(b.shape == (H // 4, W, 4)
                                    for b in blocks)
    for _ in range(3):
        resumed.update(dt=0.016, sync=True)
    assert resumed.params.frames == straight.params.frames
    assert resumed.renderer.read_framebuffer().tobytes() \
        == straight.renderer.read_framebuffer().tobytes()
    for eng in (straight, single, resumed):
        eng.scene_manager.shutdown()


def test_render_batch_on_a_mesh():
    """``render_batch`` over a mesh (``render_frames_batched_mesh``) equals
    four ``render`` calls on it, segments summed."""
    ts = instantiate_scene(scenes.room())
    p = RenderParams(width=W, height=H, bounces=2, rays_per_pixel=1,
                     skybox=True, frames=0)
    seq = Renderer(device="cpu", mesh=cpu_mesh(4))
    segs = 0
    for f in range(4):
        seq.render(ts, dataclasses.replace(p, frames=f))
        segs += int(seq.last_segments)
    bat = Renderer(device="cpu", mesh=cpu_mesh(4))
    out = bat.render_batch(ts, p, 4)
    assert out is bat.framebuffer
    assert np.asarray(out).tobytes() == seq.read_framebuffer().tobytes()
    assert int(bat.last_segments) == segs


def test_cli_on_a_mesh(tmp_path, monkeypatch):
    """The CLI has no mesh flag: it shards through ``Renderer``'s default,
    here with the host's cards stood in for by a CPU mesh of 4. Straight,
    stopped and resumed, and ``--batch 4`` give one checkpoint, byte for
    byte."""
    adopted = []

    def four(height, device):
        adopted.append(height)
        return cpu_mesh(4)

    monkeypatch.setattr(sharding, "auto_mesh", four)
    base = ["--scene", "metal", "--width", str(W), "--height", str(H),
            "--bounces", "2", "--log-every", "0", "--device", "cpu"]

    def run(name, spp, *extra):
        return main([*base, "--spp", str(spp), "-o",
                     str(tmp_path / f"{name}.png"), "--checkpoint",
                     str(tmp_path / f"{name}.npz"), *extra])

    assert run("straight", 8) == 0
    assert run("resumed", 4) == 0
    assert run("resumed", 8, "--resume") == 0
    assert run("batched", 8, "--batch", "4") == 0
    assert adopted and set(adopted) == {H}
    fbs = [load_checkpoint(tmp_path / f"{n}.npz")["framebuffer"]
           for n in ("straight", "resumed", "batched")]
    assert fbs[0].tobytes() == fbs[1].tobytes() == fbs[2].tobytes()
    assert np.isfinite(fbs[0]).all() and fbs[0].max() > 0


def test_viewer_reads_back_a_sharded_framebuffer():
    """The viewer's render loop on an engine over a mesh: its PNG decodes
    to the export of the gathered framebuffer."""
    eng = _engine(cpu_mesh(4))
    vs = ViewerServer(eng, port=0)
    loop = threading.Thread(target=vs._render_loop)
    loop.start()
    _wait_frame(vs, after=2)
    vs._stop.set()
    loop.join(timeout=30)
    assert not loop.is_alive()
    assert isinstance(eng.renderer.framebuffer, ShardedFramebuffer)
    want = framebuffer_to_srgb(eng.renderer.read_framebuffer())
    assert np.array_equal(_decode_png(vs._frame_png), want)
    assert want.max() > 0
    eng.scene_manager.shutdown()


@pytest.mark.parametrize("name", ["room", "wide_bvh_scene"])
def test_debug_row_windows(name):
    """The debug path's row window: each window of a shuffled uneven split
    equals the same rows of the whole frame, per-ray counts exactly and
    colours bit for bit in every mode but the UV's (3), within ``ULP_TOL``
    there: a sphere's UV takes ``atan2`` and ``acos``, which the CPU rounds
    by an ulp with a pixel's place in the batch (measured 3e-8 and 4.5e-8
    on these scenes)."""
    ts = instantiate_scene(getattr(scenes, name)())
    w, h = 20, 18
    rng = np.random.default_rng(7)
    cuts = sorted(rng.choice(np.arange(1, h), size=3, replace=False))
    windows = list(zip([0, *cuts], [*cuts, h]))
    rng.shuffle(windows)
    for mode in range(1, 8):
        kw = dict(width=w, height=h, debug_mode=mode, debug_scale=100.0)
        whole, counts = render_debug(ts, **kw)
        for a, b in windows:
            img, c = render_debug(ts, row_start=a, rows=b - a, **kw)
            assert img.shape == (b - a, w, 4)
            assert torch.equal(c, counts[a:b]), (mode, a, b)
            if mode == DebugMode.TEX_COORDS:
                torch.testing.assert_close(img, whole[a:b], rtol=0,
                                           atol=ULP_TOL)
            else:
                assert torch.equal(img, whole[a:b]), (mode, a, b)


def test_debug_frame_row_sharded_equals_single():
    """A debug frame through ``Renderer`` on a mesh of 6 (3-row tiles)."""
    ts = instantiate_scene(scenes.room())
    p = RenderParams(width=W, height=18, bounces=1, frames=0,
                     debug_mode=DebugMode.DEPTH)
    a = Renderer(device="cpu", mesh=cpu_mesh(6)).render(ts, p)
    b = Renderer(device="cpu", mesh=None).render(ts, p)
    assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_chip_smoke_frame_helpers_take_the_default_mesh(monkeypatch):
    """``chip_smoke.py``'s frame helpers wait for and read a renderer
    through its own ``synchronize`` and readback, so they run on the
    default mesh of a host with several cards, here stood in for by a CPU
    mesh of 4 (``auto_mesh`` monkeypatched), with the single-device
    renderer's results; and its several-card branch (``auto_mesh_frames``)
    is reached, its frame bit-equal (bounces 0) to one device's."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    monkeypatch.setattr(sharding, "auto_mesh",
                        lambda height, device: cpu_mesh(4))
    ts = instantiate_scene(scenes.room())
    p = RenderParams(width=W, height=H, bounces=0, rays_per_pixel=1,
                     skybox=True)

    def renderers():
        auto, one = Renderer(device="cpu"), Renderer(device="cpu", mesh=None)
        auto.ensure_framebuffer(W, H)
        assert auto.mesh is not None and one.mesh is None
        return auto, one

    auto, one = renderers()
    _, segs = chip_smoke.drive(auto, ts, p, frames=3)
    assert segs == chip_smoke.drive(one, ts, p, frames=3)[1]
    auto, one = renderers()
    assert chip_smoke.time_to_spp(auto, ts, p, spp=3)[1] \
        == chip_smoke.time_to_spp(one, ts, p, spp=3)[1]
    auto, one = renderers()
    assert chip_smoke.sample_variance(auto, ts, p, frames=3) \
        == chip_smoke.sample_variance(one, ts, p, frames=3)
    cards = chip_smoke.auto_mesh_frames(ts, p, device="cpu")
    assert cards["mesh"] == ["cpu"] * 4 and cards["bit_equal"]
    monkeypatch.setattr(sharding, "auto_mesh", lambda height, device: None)
    assert chip_smoke.auto_mesh_frames(ts, p, device="cpu") is None

