"""Headless offline renderer: ``python -m ray_tracer_2_tpu_torch`` (port of
``python -m ray_tracer_2_tpu``, the reference's ``__main__.py``).

Pick a scene, accumulate N samples a pixel progressively (one frame is one
sample, the accumulation protocol of ray_tracer.wgsl:154-161), write a
gamma-encoded PNG, and optionally checkpoint and resume the accumulation
(``engine/checkpoint.py``: the resume is bit-exact, since every draw is a
counter hash of (pixel, frame); the checkpoint loads in either package).
It renders on the card unless ``--device cpu`` asks for the CPU.

Examples:
    python -m ray_tracer_2_tpu_torch --scene room --spp 256 -o room.png
    python -m ray_tracer_2_tpu_torch --scene sponza --spp 1024 \\
        --checkpoint sponza.ckpt.npz --checkpoint-every 128 --resume
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

log = logging.getLogger("ray_tracer_2_tpu_torch.render")


def _builders():
    from ray_tracer_2_tpu_torch.scene import scenes
    return {
        "balls": scenes.balls,
        "random_balls": scenes.random_balls,
        "room": scenes.room,
        "room2": scenes.room_2,
        "metal": scenes.metal,
        "sponza": scenes.sponza,
        "cornell": scenes.cornell_box,
        "texture_test": scenes.texture_test,
        "obj_test": scenes.obj_test,
        "bugatti": scenes.bugatti,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tracer_2_tpu_torch",
        description="Offline progressive path-trace render to PNG.")
    ap.add_argument("--scene", default="cornell",
                    help="built-in scene name (default: cornell); one of: "
                         "balls random_balls room room2 metal sponza cornell "
                         "texture_test obj_test bugatti")
    ap.add_argument("--spp", type=int, default=256,
                    help="samples per pixel to accumulate (default 256)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--rpp", type=int, default=1,
                    help="rays per pixel per frame (intra-frame samples)")
    ap.add_argument("--no-skybox", action="store_true")
    ap.add_argument("--normal-maps", action="store_true",
                    help="normal-map shading in the lit path (the reference "
                         "stubs it, ray_tracer.wgsl:440-447)")
    ap.add_argument("--antialias", action="store_true",
                    help="sub-pixel box-filter jitter per sample (the "
                         "reference never jitters the pixel grid)")
    ap.add_argument("--nee", action="store_true",
                    help="next-event estimation: explicit light sampling "
                         "at diffuse bounces")
    ap.add_argument("--debug-mode", type=int, default=0, choices=range(8),
                    help="0 lit, 1-7 debug channels (ray_tracer.wgsl:502-573)")
    ap.add_argument("-o", "--output", default="render.png")
    ap.add_argument("--checkpoint", default=None,
                    help="accumulation checkpoint path (.npz)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the checkpoint every K frames (0 = only at "
                         "the end, if --checkpoint is set)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    ap.add_argument("--log-every", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per Renderer.render_batch call, queued "
                         "without a host synchronisation between them "
                         "(bit-identical to --batch 1)")
    ap.add_argument("--device", default="cuda",
                    help="the device to render on (default cuda; cpu runs "
                         "the plain PyTorch versions)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")

    builders = _builders()
    if args.scene not in builders:
        ap.error(f"unknown scene {args.scene!r}; choose from "
                 f"{' '.join(sorted(builders))}")

    import dataclasses

    import torch

    from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
    from ray_tracer_2_tpu_torch.engine.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    from ray_tracer_2_tpu_torch.engine.export import save_png
    from ray_tracer_2_tpu_torch.engine.renderer import Renderer
    from ray_tracer_2_tpu_torch.scene.render_scene import \
        instantiate_host_scene

    device = torch.device(args.device)
    params = RenderParams(
        width=args.width, height=args.height, bounces=args.bounces,
        rays_per_pixel=args.rpp, skybox=not args.no_skybox, frames=0,
        debug_mode=DebugMode(args.debug_mode),
        normal_maps=args.normal_maps, antialias=args.antialias,
        nee=args.nee)

    t0 = time.perf_counter()
    host = instantiate_host_scene(builders[args.scene]()).to(device)
    log.info("scene %s instantiated in %.1f s (%d spheres, %d tris)",
             args.scene, time.perf_counter() - t0, host.n_spheres,
             host.n_triangles)

    renderer = Renderer(device=device)
    start_frame = 0
    ckpt = Path(args.checkpoint) if args.checkpoint else None
    if args.resume and ckpt is not None and ckpt.exists():
        state = load_checkpoint(ckpt)
        rp = state["params"]
        if (rp.width, rp.height) != (args.width, args.height):
            log.error("checkpoint resolution %dx%d != requested %dx%d",
                      rp.width, rp.height, args.width, args.height)
            return 2
        if state["scene_name"] not in (None, args.scene):
            log.error("checkpoint is for scene %r, requested %r",
                      state["scene_name"], args.scene)
            return 2
        # every frame blends in with weight 1/(f+1): mixing estimators
        # (other bounces or physics flags) would average two images
        for f in ("bounces", "rays_per_pixel", "skybox", "nee", "antialias",
                  "normal_maps", "debug_mode"):
            if getattr(rp, f) != getattr(params, f):
                log.error("checkpoint %s=%r != requested %r — refusing to "
                          "mix estimators in one accumulation", f,
                          getattr(rp, f), getattr(params, f))
                return 2
        renderer.ensure_framebuffer(rp.width, rp.height)
        renderer.framebuffer.copy_(torch.from_numpy(state["framebuffer"]))
        start_frame = rp.frames + 1
        log.info("resumed %s at frame %d from %s", args.scene, start_frame,
                 ckpt)

    if start_frame >= args.spp:
        log.info("checkpoint already has %d >= %d spp; writing PNG only",
                 start_frame, args.spp)

    def _save_ckpt(frame: int) -> None:
        save_checkpoint(ckpt, renderer.read_framebuffer(),
                        dataclasses.replace(params, frames=frame),
                        scene_name=args.scene, camera=host.camera)
        log.info("checkpoint @ frame %d -> %s", frame, ckpt)

    t0 = time.perf_counter()
    fb = renderer.framebuffer
    last_frame = start_frame - 1
    batch = max(args.batch, 1)
    f = start_frame
    while f < args.spp:
        k = min(batch, args.spp - f)
        frame_params = dataclasses.replace(params, frames=f)
        if k > 1:
            fb = renderer.render_batch(host.scene, frame_params, k)
        else:
            fb = renderer.render(host.scene, frame_params)
        f += k
        last_frame = f - 1
        done = f - start_frame
        crossed = args.log_every and (
            (done // args.log_every) > (done - k) // args.log_every)
        if args.log_every and (crossed or f == args.spp):
            segs = int(renderer.last_segments)   # waits for the frames
            dt = time.perf_counter() - t0
            rate = f"{segs * (done / k) / dt / 1e6:.1f} Mrays/s" \
                if segs else ""
            log.info("frame %d/%d  %.3f s  %.4f s/frame  %s",
                     f, args.spp, dt, dt / done, rate)
        if (ckpt is not None and args.checkpoint_every
                and done % args.checkpoint_every == 0
                and f != args.spp):
            _save_ckpt(last_frame)

    if fb is None:
        log.error("nothing rendered and no checkpoint framebuffer")
        return 2
    if ckpt is not None and last_frame >= start_frame:
        _save_ckpt(last_frame)
    save_png(renderer.read_framebuffer(), args.output)
    log.info("wrote %s (%d spp, %dx%d)", args.output,
             max(last_frame + 1, start_frame), args.width, args.height)
    return 0


if __name__ == "__main__":
    sys.exit(main())
