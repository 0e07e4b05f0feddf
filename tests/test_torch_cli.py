"""The headless render command, ``python -m ray_tracer_2_tpu_torch`` (the
reference's ``tests/test_cli.py`` on the port, run in process with
``--device cpu``): a progressive render to PNG with a bit-exact resume
from its checkpoint, the three refusals to resume (resolution, scene,
estimator), an unknown scene, ``--batch`` equal to single frames, and a
debug mode written as the PNG of its framebuffer."""
import dataclasses

import numpy as np
import PIL.Image
import pytest

from ray_tracer_2_tpu_torch.__main__ import main
from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
from ray_tracer_2_tpu_torch.engine.checkpoint import load_checkpoint
from ray_tracer_2_tpu_torch.engine.export import framebuffer_to_srgb
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels.debug import render_debug_plain
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
from torch_bridge import one_torch_thread  # noqa: F401

W, H, SPP = 40, 24, 5
BASE = ["--width", str(W), "--height", str(H), "--log-every", "0",
        "--device", "cpu"]


def _run(tmp_path, name, *extra, scene="metal", spp=SPP, bounces=2):
    return main(["--scene", scene, "--spp", str(spp), "--bounces",
                 str(bounces), "-o", str(tmp_path / f"{name}.png"), *BASE,
                 *extra])


def _frames(spp, bounces=2):
    ts = instantiate_scene(scenes.metal())
    p = RenderParams(width=W, height=H, bounces=bounces)
    r = Renderer(device="cpu")
    for f in range(spp):
        fb = r.render(ts, dataclasses.replace(p, frames=f))
    return fb.numpy()


def test_render_and_bitexact_resume(tmp_path):
    ck = tmp_path / "a.npz"
    assert _run(tmp_path, "a", "--checkpoint", str(ck), spp=3) == 0
    assert load_checkpoint(ck)["params"].frames == 2
    assert _run(tmp_path, "a", "--checkpoint", str(ck), "--resume") == 0
    state = load_checkpoint(ck)
    want = _frames(SPP)
    assert state["params"].frames == SPP - 1
    assert state["scene_name"] == "metal"
    assert state["framebuffer"].tobytes() == want.tobytes()
    png = np.asarray(PIL.Image.open(tmp_path / "a.png"))
    assert np.array_equal(png, framebuffer_to_srgb(want))


@pytest.mark.parametrize("extra", [
    ["--width", "32"], ["--scene", "room"], ["--bounces", "3"],
    ["--antialias"], ["--rpp", "2"]])
def test_resume_refusals(tmp_path, extra):
    """A checkpoint of another resolution, scene or estimator is refused
    (exit code 2), never blended in."""
    ck = tmp_path / "b.npz"
    assert _run(tmp_path, "b", "--checkpoint", str(ck), spp=2) == 0
    before = ck.read_bytes()
    args = ["--checkpoint", str(ck), "--resume"]
    argv = ["--scene", "metal", "--spp", "4", "--bounces", "2", "-o",
            str(tmp_path / "b.png"), *BASE, *args, *extra]
    assert main(argv) == 2
    assert ck.read_bytes() == before


def test_unknown_scene():
    with pytest.raises(SystemExit):
        main(["--scene", "nope", "--spp", "1", "--device", "cpu"])


def test_batch_equals_single_frames(tmp_path):
    """``--batch 3`` over 5 frames (a batch of 3, then of 2) writes the
    checkpoint ``--batch 1`` writes, byte for byte."""
    for name, batch in (("one", "1"), ("three", "3")):
        assert _run(tmp_path, name, "--batch", batch, "--checkpoint",
                    str(tmp_path / f"{name}.npz")) == 0
    one = load_checkpoint(tmp_path / "one.npz")["framebuffer"]
    three = load_checkpoint(tmp_path / "three.npz")["framebuffer"]
    assert one.tobytes() == three.tobytes()


def test_debug_mode_png(tmp_path):
    """``--debug-mode 2`` (depth) writes the PNG of the plain debug path's
    image."""
    assert _run(tmp_path, "d", "--debug-mode", "2", spp=2) == 0
    png = np.asarray(PIL.Image.open(tmp_path / "d.png"))
    want, _ = render_debug_plain(instantiate_scene(scenes.metal()), width=W,
                                 height=H, debug_mode=int(DebugMode.DEPTH),
                                 debug_scale=100.0)
    assert np.array_equal(png, framebuffer_to_srgb(want.numpy()))
    assert png.shape == (H, W, 3) and png.max() > 0
