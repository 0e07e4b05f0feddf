#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, then drives the main path —
``Renderer.render`` -> ``render_persistent`` -> the kernel — at 1920x1080,
5 bounces, on the 80,000-triangle headline scene, and checks that every
frame went through the kernel. Each phase prints one JSON line; the line
before the last lists the kernels, the last line is the result. Any failed
check raises, so the exit code is non-zero and no result line is printed.
It needs one CUDA card and imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

W, H, BOUNCES, FRAMES = 1920, 1080, 5, 6
SMALL_W, SMALL_H = 128, 72
# Kernel and plain version keep one op order and share the CUDA libm, so
# they are held to exact segments and this share of pixels within
# PIXEL_TOL at every bounce count.
PIXEL_TOL = 1e-5
NEED_FRAC = 0.999


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(fn):
    """Run ``fn`` once on the card; return (result, milliseconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def kernel_ms(fn, reps=5):
    """Mean device time of ``reps`` back-to-back launches (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(scene, width, height, bounces, kernel, plain):
    """Kernel vs plain version on the same scene and frame; the kernel is
    timed over repeated launches after the compared one, the plain version
    on the compared call."""
    kw = dict(width=width, height=height, bounces=bounces, rays_per_pixel=1,
              skybox=True)
    ki, ks = kernel(scene, 1, **kw)
    k_ms = kernel_ms(lambda: kernel(scene, 1, **kw))
    (pi, ps), p_ms = timed(lambda: plain(scene, 1, **kw))
    check(bool(torch.isfinite(ki).all()), "kernel image finite")
    err = (ki - pi).abs().amax(dim=-1)
    return dict(width=width, height=height, bounces=bounces,
                segments_kernel=int(ks), segments_plain=int(ps),
                frac_within_tol=float((err < PIXEL_TOL).float().mean()),
                frac_lit=float((pi[..., :3] > 0).any(dim=-1).float().mean()),
                max_abs_err=float(err.max()), kernel_ms=k_ms, plain_ms=p_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ray_tracer_2_tpu_torch.config import RenderParams
    from ray_tracer_2_tpu_torch.engine.renderer import Renderer
    from ray_tracer_2_tpu_torch.kernels.megakernel import (
        CUDA_MEGAKERNEL, render_plain,
    )
    from ray_tracer_2_tpu_torch.scene import scenes
    from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene

    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit(phase="device", nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    CUDA_MEGAKERNEL.build()
    ptxas = [ln.strip() for ln in CUDA_MEGAKERNEL.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=CUDA_MEGAKERNEL.build_seconds, ptxas=ptxas)

    # ---- 3. kernel against plain version, on the card ---------------------
    small = instantiate_scene(scenes.wide_bvh_scene()).to("cuda")
    t0 = time.perf_counter()
    main_scene = instantiate_scene(scenes.main_path_scene()).to("cuda")
    scene_s = time.perf_counter() - t0
    cases = [(small, SMALL_W, SMALL_H, 0), (small, SMALL_W, SMALL_H, 5),
             (main_scene, W, H, 0), (main_scene, W, H, BOUNCES)]
    results = []
    for scene, w, h, b in cases:
        r = compare(scene, w, h, b, CUDA_MEGAKERNEL, render_plain)
        emit(phase="kernel_vs_plain", need_frac=NEED_FRAC, **r)
        check(r["segments_kernel"] == r["segments_plain"],
              f"exact segments at bounces={b} ({w}x{h})")
        check(r["frac_within_tol"] >= NEED_FRAC,
              f"{r['frac_within_tol']:.4f} of pixels within {PIXEL_TOL} "
              f"(need {NEED_FRAC}) at bounces={b} ({w}x{h})")
        # the compared images must hold light: sky at every bounce count
        check(r["frac_lit"] >= 0.1, f"{r['frac_lit']:.4f} of pixels lit "
                                    f"at bounces={b} ({w}x{h})")
        results.append(r)
    main_cmp = results[-1]

    # ---- 4. the main path -------------------------------------------------
    renderer = Renderer(device="cuda")
    params = RenderParams(width=W, height=H, bounces=BOUNCES,
                          rays_per_pixel=1, skybox=True)
    CUDA_MEGAKERNEL.launches = 0
    segs = []
    t_start = None
    for f in range(FRAMES):
        if f == 2:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        renderer.render(main_scene, dataclasses.replace(params, frames=f))
        segs.append(renderer.last_segments)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    launches = CUDA_MEGAKERNEL.launches
    timed_segs = sum(int(s) for s in segs[2:])
    all_segs = sum(int(s) for s in segs)
    fb = renderer.read_framebuffer()
    check(launches == FRAMES, f"kernel launched {launches} times in "
                              f"{FRAMES} main-path frames")
    check(bool(torch.isfinite(renderer.framebuffer).all()),
          "framebuffer finite")
    check(float(abs(fb).max()) > 0.0, "framebuffer not all zero")
    check(all_segs >= W * H * FRAMES, "at least one segment per pixel")
    check("jax" not in sys.modules, "jax not imported")
    frame_ms = dt * 1e3 / (FRAMES - 2)
    emit(phase="main_path", scene="main_path_scene (80,000 tris + ground "
         "sphere)", width=W, height=H, bounces=BOUNCES, rpp=1,
         frames=FRAMES, scene_build_s=scene_s, launches=launches,
         segments=all_segs, timed_frames="2-5", timed_segments=timed_segs,
         ms_per_frame=frame_ms, mrays_per_s=timed_segs / dt / 1e6,
         card=card)

    emit(kernels=[dict(
        name="megakernel", route="cuda",
        source="ray_tracer_2_tpu_torch/csrc/megakernel.cu",
        replaces="ray_tracer_2_tpu/kernels/pallas_boundary.py:236",
        launches=launches, max_abs_err=main_cmp["max_abs_err"],
        ms=main_cmp["kernel_ms"], plain_ms=main_cmp["plain_ms"])])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
