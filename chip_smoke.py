#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's three CUDA kernels from the sources in this checkout
(one nvcc each, side by side) and holds each against its plain PyTorch
version on the card. Then it drives three paths through
``Renderer.render`` at 1920x1080, 5 bounces, and checks that every frame
went through the path's kernel and no other:

* the main path — ``render_persistent`` -> ``csrc/megakernel.cu`` — on the
  80,000-triangle headline scene;
* the small-scene path — ``render_spheres`` -> ``csrc/spheres.cu`` — on
  ``random_balls`` (485 spheres, glass, specular);
* the room2 path — ``render_persistent`` -> ``csrc/megakernel.cu``, whose
  segment prepass runs the brute-force loop of ``csrc/brute.cuh`` (the
  loop of ``csrc/brute.cu``; the kernel counts its calls on the device) —
  on ``room2_scene`` (two instances of one shared 80,000-triangle soup, a
  16-triangle brute-force group, a glass sphere, depth of field).

The megakernel is also held against its plain version on
``instances_scene``, where four instances of two shared tables take 38%
of the primary rays.

Each phase prints one JSON line; the line before the last lists the
kernels, the last line is the result. Any failed check raises, so the exit
code is non-zero and no result line is printed. It needs one CUDA card and
imports nothing of JAX.
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
# room2's soup in its 128x72 cells (the 1080p cells take the full 200x200)
ROOM2_SMALL_SOUP = 12
# the brute kernel's check: one ray per 1080p pixel against a 256-triangle
# group; tri and mat exact, this share of rays within PIXEL_TOL on
# dst, u, v and det
BRUTE_RAYS = W * H
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


def check_cases(cases, launch, plain, **tags):
    """``compare`` on each (scene name, scene, width, height, bounces) case,
    held to exact segments, NEED_FRAC of pixels within PIXEL_TOL and >= 10%
    of pixels lit. Returns the results in order."""
    results = []
    for name, scene, w, h, b in cases:
        r = compare(scene, w, h, b, launch, plain)
        emit(phase="kernel_vs_plain", scene=name, need_frac=NEED_FRAC,
             **tags, **r)
        where = f"{name} at bounces={b} ({w}x{h})"
        check(r["segments_kernel"] == r["segments_plain"],
              f"exact segments, {where}")
        check(r["frac_within_tol"] >= NEED_FRAC,
              f"{r['frac_within_tol']:.4f} of pixels within {PIXEL_TOL} "
              f"(need {NEED_FRAC}), {where}")
        # the compared images must hold light: sky at every bounce count
        check(r["frac_lit"] >= 0.1, f"{r['frac_lit']:.4f} of pixels lit, "
                                    f"{where}")
        results.append(r)
    return results


def brute_group():
    """A scene whose one instance group holds 256 triangles of mixed cull:
    a 128-triangle soup of a diffuse material and, inside it, one of
    glass (two-sided)."""
    from ray_tracer_2_tpu_torch.math.transform import Transform
    from ray_tracer_2_tpu_torch.scene import scenes
    from ray_tracer_2_tpu_torch.scene.definition import (
        MeshFromData, SceneDefinition,
    )
    from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
    from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
    s = SceneDefinition()
    s.add_mesh(Transform(), MeshFromData(scenes.latlon_soup(8, 8, 1.0)),
               MaterialDefinition.new())
    s.add_mesh(Transform(), MeshFromData(scenes.latlon_soup(8, 8, 0.5)),
               MaterialDefinition.new().glass(1.5))
    return instantiate_scene(s).to("cuda")


def compare_brute(seed: int = 0):
    """``rt2_brute_intersect`` against ``brute_force_intersect_plain`` on
    BRUTE_RAYS rays from ``seed`` (origins in a 3-unit box around the
    group, directions uniform)."""
    import numpy as np
    from ray_tracer_2_tpu_torch.kernels.brute import (
        CUDA_BRUTE, INF, brute_force_intersect_plain, pack_brute_table,
    )
    scene = brute_group()
    _, tri_off, count = scene.inst_spans[0]
    check(count == 256, f"brute group of {count} triangles")
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (BRUTE_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(BRUTE_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    table = pack_brute_table(scene, tri_off, count)
    rays = torch.cat([o, d, torch.zeros_like(o[:, :2])], dim=1).contiguous()
    out = CUDA_BRUTE(rays, table, count)
    k_ms = kernel_ms(lambda: CUDA_BRUTE(rays, table, count), reps=20)
    ref, p_ms = timed(lambda: brute_force_intersect_plain(
        scene, o, d, tri_off, count))
    tri = torch.where(out[:, 0] < INF, tri_off + out[:, 5].long(), -1)
    err = torch.stack([(out[:, c] - ref[k]).abs() for c, k in
                       enumerate(("dst", "u", "v", "det"))]).amax(dim=0)
    hit = ref["tri"] >= 0
    culled = table[:, 10] > 0.5
    r = dict(rays=BRUTE_RAYS, triangles=count,
             culled=int(culled.sum()), two_sided=int((~culled).sum()),
             hits=int(hit.sum()),
             tri_exact=bool((tri == ref["tri"]).all()),
             mat_exact=bool((out[:, 4].long() == ref["mat"]).all()),
             frac_within_tol=float((err < PIXEL_TOL).float().mean()),
             max_abs_err=float(err[hit].max()) if bool(hit.any()) else 0.0,
             kernel_ms=k_ms, plain_ms=p_ms)
    emit(phase="kernel_vs_plain", kernel="brute", need_frac=NEED_FRAC, **r)
    check(r["tri_exact"] and r["mat_exact"], "brute kernel: tri and mat "
                                             "exact")
    check(r["frac_within_tol"] >= NEED_FRAC,
          f"brute kernel: {r['frac_within_tol']:.5f} of rays within "
          f"{PIXEL_TOL} (need {NEED_FRAC})")
    check(0.05 * BRUTE_RAYS <= r["hits"] < BRUTE_RAYS, "brute kernel: a "
          "share of the rays hit")
    return r


def drive(renderer, scene, params):
    """FRAMES progressive frames through ``Renderer.render``, frames 2-5
    timed on the host clock after a synchronise. Returns (seconds of the
    timed frames, segments of each frame)."""
    segs = []
    t_start = None
    for f in range(FRAMES):
        if f == 2:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        renderer.render(scene, dataclasses.replace(params, frames=f))
        segs.append(renderer.last_segments)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    fb = renderer.read_framebuffer()
    check(bool(torch.isfinite(renderer.framebuffer).all()),
          "framebuffer finite")
    check(float(abs(fb).max()) > 0.0, "framebuffer not all zero")
    segs = [int(s) for s in segs]
    check(sum(segs) >= W * H * FRAMES, "at least one segment per pixel")
    return dt, segs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ray_tracer_2_tpu_torch.config import RenderParams
    from ray_tracer_2_tpu_torch.engine.renderer import Renderer
    from ray_tracer_2_tpu_torch.kernels.brute import CUDA_BRUTE
    from ray_tracer_2_tpu_torch.kernels.cuda_build import build_all
    from ray_tracer_2_tpu_torch.kernels.megakernel import (
        CUDA_MEGAKERNEL, brute_instances, render_plain,
    )
    from ray_tracer_2_tpu_torch.kernels.spheres import (
        CUDA_SPHERES, render_spheres_plain,
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

    # ---- 2. build: one nvcc per source, side by side ---------------------
    t0 = time.perf_counter()
    kernels = (CUDA_MEGAKERNEL, CUDA_SPHERES, CUDA_BRUTE)
    build_all(*kernels)
    for k in kernels:
        ptxas = [ln.strip() for ln in k.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit(phase="build", source=k.source.name,
             nvcc_seconds=k.build_seconds, ptxas=ptxas)
    emit(phase="build", seconds=time.perf_counter() - t0)

    # ---- 3. each kernel against its plain version, on the card -----------
    CUDA_BRUTE.reset_counts()
    brute_cmp = compare_brute()
    brute_check_launches = CUDA_BRUTE.launches
    small = instantiate_scene(scenes.wide_bvh_scene()).to("cuda")
    t0 = time.perf_counter()
    main_scene = instantiate_scene(scenes.main_path_scene()).to("cuda")
    scene_s = time.perf_counter() - t0
    main_cmp = check_cases(
        [("wide_bvh_scene", small, SMALL_W, SMALL_H, 0),
         ("wide_bvh_scene", small, SMALL_W, SMALL_H, 5),
         ("main_path_scene", main_scene, W, H, 0),
         ("main_path_scene", main_scene, W, H, BOUNCES)],
        CUDA_MEGAKERNEL, render_plain, kernel="megakernel")[-1]
    room2_small = instantiate_scene(scenes.room2_scene(
        ROOM2_SMALL_SOUP, ROOM2_SMALL_SOUP)).to("cuda")
    t0 = time.perf_counter()
    room2 = instantiate_scene(scenes.room2_scene()).to("cuda")
    room2_s = time.perf_counter() - t0
    small_name = f"room2_scene ({ROOM2_SMALL_SOUP}x{ROOM2_SMALL_SOUP} soup)"
    insts = instantiate_scene(scenes.instances_scene()).to("cuda")
    check_cases(
        [(small_name, room2_small, SMALL_W, SMALL_H, 0),
         (small_name, room2_small, SMALL_W, SMALL_H, BOUNCES),
         ("room2_scene", room2, W, H, 0),
         ("room2_scene", room2, W, H, BOUNCES),
         ("instances_scene", insts, SMALL_W, SMALL_H, 0),
         ("instances_scene", insts, SMALL_W, SMALL_H, BOUNCES),
         ("instances_scene", insts, W, H, BOUNCES)],
        CUDA_MEGAKERNEL, render_plain, kernel="megakernel")
    rballs = instantiate_scene(scenes.random_balls()).to("cuda")
    room = instantiate_scene(scenes.room()).to("cuda")
    sph_cmp = check_cases(
        [("random_balls", rballs, SMALL_W, SMALL_H, 0),
         ("random_balls", rballs, SMALL_W, SMALL_H, BOUNCES),
         ("room", room, SMALL_W, SMALL_H, 0),
         ("room", room, SMALL_W, SMALL_H, BOUNCES),
         ("room", room, W, H, BOUNCES),
         ("random_balls", rballs, W, H, BOUNCES)],
        CUDA_SPHERES, render_spheres_plain, kernel="spheres")[-1]

    # ---- 4. the main path -------------------------------------------------
    params = RenderParams(width=W, height=H, bounces=BOUNCES,
                          rays_per_pixel=1, skybox=True)
    def zero_counts():
        for k in kernels:
            k.reset_counts()

    zero_counts()
    dt, segs = drive(Renderer(device="cuda"), main_scene, params)
    launches = CUDA_MEGAKERNEL.launches
    check(launches == FRAMES, f"megakernel launched {launches} times in "
                              f"{FRAMES} main-path frames")
    check(CUDA_SPHERES.launches == 0, "no small-scene launch on the main "
                                      "path")
    check(CUDA_MEGAKERNEL.prepass_counts() == (0, 0),
          "no brute-force prepass on the main path")
    emit(phase="main_path", scene="main_path_scene (80,000 tris + ground "
         "sphere)", width=W, height=H, bounces=BOUNCES, rpp=1,
         frames=FRAMES, scene_build_s=scene_s, launches=launches,
         segments=sum(segs), timed_frames="2-5",
         timed_segments=sum(segs[2:]),
         ms_per_frame=dt * 1e3 / (FRAMES - 2),
         mrays_per_s=sum(segs[2:]) / dt / 1e6, card=card)

    # ---- 5. the small-scene path ------------------------------------------
    zero_counts()
    dt, segs = drive(Renderer(device="cuda"), rballs, params)
    sph_launches = CUDA_SPHERES.launches
    check(sph_launches == FRAMES, f"spheres kernel launched {sph_launches} "
                                  f"times in {FRAMES} small-scene frames")
    check(CUDA_MEGAKERNEL.launches == 0, "no megakernel launch on the "
                                         "small-scene path")
    emit(phase="small_scene_path", scene="random_balls (485 spheres)",
         width=W, height=H, bounces=BOUNCES, rpp=1, frames=FRAMES,
         launches=sph_launches, segments=sum(segs), timed_frames="2-5",
         timed_segments=sum(segs[2:]),
         ms_per_frame=dt * 1e3 / (FRAMES - 2),
         mrays_per_s=sum(segs[2:]) / dt / 1e6, card=card)

    # ---- 6. the room2 path ------------------------------------------------
    zero_counts()
    dt, segs = drive(Renderer(device="cuda"), room2, params)
    room2_launches = CUDA_MEGAKERNEL.launches
    # the kernel's own counts: closest-hit calls of the brute.cuh loop (one
    # per segment and brute-force group) and launches that made any
    brute_calls, brute_launches = CUDA_MEGAKERNEL.prepass_counts()
    check(room2_launches == FRAMES, f"megakernel launched {room2_launches} "
                                   f"times in {FRAMES} room2 frames")
    check(brute_launches == FRAMES, f"{brute_launches} of {FRAMES} room2 "
                                    "launches ran the brute-force prepass")
    groups = len(brute_instances(room2))
    check(brute_calls == groups * sum(segs),
          f"{brute_calls} brute-force calls for {sum(segs)} segments and "
          f"{groups} group(s)")
    check(CUDA_BRUTE.launches == 0, "no standalone brute launch on the "
                                    "room2 path")
    check(CUDA_SPHERES.launches == 0, "no small-scene launch on the room2 "
                                      "path")
    check("jax" not in sys.modules, "jax not imported")
    emit(phase="room2_path", scene="room2_scene (2 x 80,000 shared tris + "
         "16-tri brute group + glass sphere)", width=W, height=H,
         bounces=BOUNCES, rpp=1, frames=FRAMES, scene_build_s=room2_s,
         launches=room2_launches, brute_prepass_launches=brute_launches,
         brute_prepass_calls=brute_calls,
         segments=sum(segs), timed_frames="2-5",
         timed_segments=sum(segs[2:]),
         ms_per_frame=dt * 1e3 / (FRAMES - 2),
         mrays_per_s=sum(segs[2:]) / dt / 1e6, card=card)

    emit(kernels=[
        dict(name="megakernel", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/megakernel.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_boundary.py:236",
             launches=launches, max_abs_err=main_cmp["max_abs_err"],
             ms=main_cmp["kernel_ms"], plain_ms=main_cmp["plain_ms"]),
        dict(name="spheres", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/spheres.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_spheres.py:149",
             launches=sph_launches, max_abs_err=sph_cmp["max_abs_err"],
             ms=sph_cmp["kernel_ms"], plain_ms=sph_cmp["plain_ms"]),
        # on the render path the brute.cuh loop runs inside the
        # megakernel: launches are the room2 launches whose device counts
        # show it ran; the numbers are the standalone kernel's check
        dict(name="brute", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/brute.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_brute.py:32",
             launches=brute_launches,
             launched_as="brute.cuh loop in megakernel.cu's segment "
                         "prepass, counted on the device",
             prepass_calls=brute_calls,
             standalone_launches_in_check=brute_check_launches,
             max_abs_err=brute_cmp["max_abs_err"],
             ms=brute_cmp["kernel_ms"], plain_ms=brute_cmp["plain_ms"])])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
