"""The comparison that decides ``correct``: what the window's
``Engine.update`` produced against the plain reference (``tracer``),
worked out again from the configuration's inputs and the mouse deltas.

Two kinds of cell:

* a still camera accumulates every frame from 0 into the framebuffer.
  The reference traces each frame's path of a sample of pixels drawn from
  the seed, blends them as the renderer does (``fb (1 - w) + s w``, ``w =
  1 / (frame + 1)``, float32) and compares the accumulated values; it
  also traces the window's last frame whole and compares its exact
  segment count;
* a moving camera (or a still one with accumulation off) overwrites the
  framebuffer every frame: the reference turns its camera by every delta
  sent, traces the last frame whole at the size it was rendered and
  compares every pixel and the segment count.

The frame's size, bounces, skybox and accumulation are replayed from the
run; ``REPLAYED`` names the ``RenderParams`` fields a traffic mix may set.
A mix that needs another field (NEE, antialias, normal maps, several rays
a pixel, a debug mode) needs the reference to follow it first.

The numbers compared (each against its limit from ``cells/<cell>.json``):
``mismatch_share``, the share of compared pixels whose value differs by
more than ``TAU`` relative (per channel ``|a - b| / (1 + |b|)``);
``mean_rel_err``, the summed absolute difference over the summed
reference value (rgb); ``segments_gap``, ``|program - reference| /
reference`` of the last frame's segments. A path whose closest hit sits on
a knife edge between two triangles can take another way in each, so none
of them is 0 on a sound run.
"""
from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import tracer
from rtbench.reference.camera import Camera
from rtbench.reference.scene import RefScene

#: the relative difference from which a pixel counts as a mismatch
TAU = 1e-3
#: the ``RenderParams`` fields the reference replays from a run
REPLAYED = ("width", "height", "bounces", "skybox", "accumulate",
            "adaptive_motion", "motion_target_ms")


def blend_weights(n_frames: int) -> np.ndarray:
    """The renderer's float32 weight of frames 0 .. n - 1: 1 for frame 0,
    then 1 / (f + 1)."""
    w = np.float32(1.0) / (np.arange(n_frames, dtype=np.float32)
                           + np.float32(1.0))
    w[0] = np.float32(1.0)
    return w


def accumulate(samples: np.ndarray) -> np.ndarray:
    """(frames, k, 4) float32 samples blended in frame order, as the
    renderer blends: ``fb * (1 - w) + s * w``, each product and the sum
    rounded to float32."""
    fb = np.zeros(samples.shape[1:], np.float32)
    for f, w in enumerate(blend_weights(samples.shape[0])):
        fb = fb * (np.float32(1.0) - w) + samples[f] * w
    return fb


def still_pixels(scene: RefScene, cam: dict, pixels: np.ndarray,
                 n_frames: int, **kw) -> np.ndarray:
    """The accumulated value of ``pixels`` after frames 0 .. n - 1."""
    dev = scene.device
    pix = torch.as_tensor(pixels, device=dev).repeat(n_frames)
    fr = torch.arange(n_frames, device=dev).repeat_interleave(len(pixels))
    rad, _ = tracer.trace_blocks(scene, cam, pix, fr, **kw)
    return accumulate(rad.float().cpu().numpy().reshape(n_frames, -1, 4))


def whole_frame(scene: RefScene, cam: dict, frame: int, **kw):
    """(image (height * width, 4), segments) of one whole frame."""
    dev = scene.device
    n = kw["width"] * kw["height"]
    pix = torch.arange(n, device=dev)
    rad, segs = tracer.trace_blocks(
        scene, cam, pix, torch.full((n,), int(frame), device=dev), **kw)
    return rad.float().cpu().numpy(), int(segs.sum())


def numbers(program: np.ndarray, reference: np.ndarray, segs_program: int,
            segs_reference: int) -> dict:
    """The compared numbers of program values against reference values
    ((k, 4) each) and the two segment counts."""
    a = program.astype(np.float64)
    b = reference.astype(np.float64)
    err = (np.abs(a - b) / (1.0 + np.abs(b))).max(axis=1)
    return dict(
        mismatch_share=float((~(err <= TAU)).mean()),
        mean_rel_err=float(np.abs(a - b)[:, :3].sum()
                           / max(np.abs(b)[:, :3].sum(), 1e-30)),
        segments_gap=abs(segs_program - segs_reference)
        / max(segs_reference, 1))


def camera(inputs: dict, deltas=(), dt: float = 0.0) -> dict:
    """The camera of the inputs, turned by each (dx, dy) of ``deltas``."""
    c = Camera(inputs["camera"])
    for dx, dy in deltas:
        c.turn(dx, dy, dt)
    return c.uniform()


def reference_outputs(inputs: dict, run: dict, device,
                      dtype=torch.float32) -> dict:
    """What the reference (or, in a lower ``dtype``, the control) gives for
    a run's record: ``values`` at the compared pixels and the last frame's
    ``segments``."""
    scene = RefScene(inputs, device, dtype)
    cam = camera(inputs, run["deltas"], run["dt"])
    kw = dict(width=run["width"], height=run["height"],
              bounces=run["bounces"], skybox=run["skybox"])
    if run["overwrite"]:
        img, segs = whole_frame(scene, cam, run["frame_arg"], **kw)
        values = img[run["pixels"]]
    else:
        values = still_pixels(scene, cam, run["pixels"], run["n_frames"],
                              **kw)
        _, segs = whole_frame(scene, cam, run["n_frames"] - 1, **kw)
    return dict(values=values, segments=segs)


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, each number with its limit): correct when every number is
    at or under its limit. A number without a limit fails."""
    checks = {k: dict(value=v, limit=limits.get(k)) for k, v in found.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
