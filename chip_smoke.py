#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (the
three render kernels and the four probe sources, one nvcc each, side by
side) and holds each against its plain PyTorch
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

Both render kernels are persistent: lanes refill from a pixel cursor and
count their own work on the device. Each comparison also holds the
megakernel's interior-row, leaf and child-box visits equal to the plain
version's, and reports lane occupancy (active lanes over 32 x turns of the
lane loop) beside what one thread per pixel would have had. The kernels
line gives each kernel's bound: the larger of its operations, counted in
this run, over the card's float32 peak and its bytes over the memory rate.

Then the probe phase runs every probe kernel of ``probes/`` (the
hand-written Hopper counterparts of the TPU probe scripts
``scripts/probe_{trav,packet,r2,lut}.py``) once, at the first of its
script's sizes, through the runner of ``python3 -m
ray_tracer_2_tpu_torch.probes``, and holds each bit-equal to its plain
version on the card: output, final index and checksum.

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
# Float operations per unit of counted work, read off csrc/ (adds,
# multiplies, min/max, compares and selects; a division or square root
# counts one; integer work and transcendentals are left out, so the bound
# is a lower one):
OPS_BOX = 34            # megakernel.cu child_eval, per child box
OPS_LEAF = 8 * 47       # megakernel.cu traverse, per leaf of 8 triangles
OPS_SPHERE = 35         # the exact quadratic (both kernels), per sphere
OPS_SPHERE_FAST = 30    # spheres.cu shared-term formula, per sphere
OPS_TRI = 49            # spheres.cu triangle test, per triangle
OPS_BRUTE = 62          # brute.cuh closest_hit, per triangle
OPS_INSTANCE = 60       # megakernel.cu instance ray, limit, merge
OPS_SEGMENT = 160       # camera ray share, shading, roulette per segment


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


def one_thread_per_pixel_occupancy(pixel_segments) -> float:
    """Lane occupancy the earlier one-thread-per-pixel form had on these
    pixels: a warp of 32 consecutive pixels turned as many times as its
    longest path (all samples), one segment a turn."""
    segs = pixel_segments.reshape(-1)
    pad = (-segs.numel()) % 32
    warps = torch.cat([segs, segs.new_zeros(pad)]).view(-1, 32)
    return float(segs.sum()) / (32.0 * float(warps.amax(dim=1).sum()))


def compare(scene, width, height, bounces, kernel, plain):
    """Kernel vs plain version on the same scene and frame; the kernel is
    timed over repeated launches after the compared one, the plain version
    on the compared call. The kernel's device counts are those of the
    compared launch."""
    kw = dict(width=width, height=height, bounces=bounces, rays_per_pixel=1,
              skybox=True)
    kernel.reset_counts()
    ki, ks = kernel(scene, 1, **kw)
    kc = kernel.read_counts()
    k_ms = kernel_ms(lambda: kernel(scene, 1, **kw))
    pc = {}
    (pi, ps), p_ms = timed(lambda: plain(scene, 1, counts=pc, **kw))
    check(bool(torch.isfinite(ki).all()), "kernel image finite")
    err = (ki - pi).abs().amax(dim=-1)
    r = dict(width=width, height=height, bounces=bounces,
             segments_kernel=int(ks), segments_plain=int(ps),
             frac_within_tol=float((err < PIXEL_TOL).float().mean()),
             frac_lit=float((pi[..., :3] > 0).any(dim=-1).float().mean()),
             max_abs_err=float(err.max()), kernel_ms=k_ms, plain_ms=p_ms,
             turns=kc["turns"], active_lanes=kc["active_lanes"],
             lane_occupancy=kc["active_lanes"] / (32.0 * max(kc["turns"], 1)),
             lane_occupancy_one_thread_per_pixel=
             one_thread_per_pixel_occupancy(pc["pixel_segments"]))
    for k in ("rows", "leaves", "boxes", "brute_calls"):
        if k in kc:
            r[f"{k}_kernel"] = kc[k]
            if k in pc:
                r[f"{k}_plain"] = pc[k]
    return r


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
        for k in ("rows", "leaves", "boxes"):
            if f"{k}_plain" in r:
                check(r[f"{k}_kernel"] == r[f"{k}_plain"],
                      f"{k} visits {r[f'{k}_kernel']} (kernel) == "
                      f"{r[f'{k}_plain']} (plain), {where}")
        check(r["frac_within_tol"] >= NEED_FRAC,
              f"{r['frac_within_tol']:.4f} of pixels within {PIXEL_TOL} "
              f"(need {NEED_FRAC}), {where}")
        # the compared images must hold light: sky at every bounce count
        check(r["frac_lit"] >= 0.1, f"{r['frac_lit']:.4f} of pixels lit, "
                                    f"{where}")
        results.append(r)
    return results


def megakernel_bound(scene, r) -> dict:
    """Bound of the megakernel on a compared cell: its counted child boxes,
    leaves and segments (each segment tests every sphere and brute-force
    triangle and transforms the ray into every instance), against its
    tables read once and the image written once."""
    from ray_tracer_2_tpu_torch.kernels.megakernel import brute_instances
    from ray_tracer_2_tpu_torch.probes.common import bound, nbytes
    brute_tris = sum(scene.inst_spans[i][2] for i in brute_instances(scene))
    per_seg = (scene.n_spheres * OPS_SPHERE + brute_tris * OPS_BRUTE
               + scene.n_instances * OPS_INSTANCE + OPS_SEGMENT)
    ops = (r["boxes_kernel"] * OPS_BOX + r["leaves_kernel"] * OPS_LEAF
           + r["segments_kernel"] * per_seg)
    return bound(ops, nbytes(scene.wide_rows, scene.tri_attr, scene.mat_rows)
                 + r["width"] * r["height"] * 16)


def spheres_bound(scene, r) -> dict:
    """Bound of the small-scene kernel on a compared cell: every segment
    tests every sphere and triangle; its tables read once, the image
    written once."""
    from ray_tracer_2_tpu_torch.kernels.intersect import SPHERE_FAST_MIN
    from ray_tracer_2_tpu_torch.kernels.spheres import pack_tables
    from ray_tracer_2_tpu_torch.probes.common import bound, nbytes
    tab = pack_tables(scene)
    s, t = tab.n_spheres, tab.n_tris
    per_seg = (s * (OPS_SPHERE_FAST if s >= SPHERE_FAST_MIN else OPS_SPHERE)
               + t * OPS_TRI + OPS_SEGMENT)
    return bound(r["segments_kernel"] * per_seg,
                 nbytes(tab.spheres, tab.tris, tab.fields)
                 + r["width"] * r["height"] * 16)


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
    from ray_tracer_2_tpu_torch.probes.common import bound, nbytes
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
             kernel_ms=k_ms, plain_ms=p_ms,
             **bound(BRUTE_RAYS * count * OPS_BRUTE,
                     nbytes(rays, table, out)))
    emit(phase="kernel_vs_plain", kernel="brute", need_frac=NEED_FRAC, **r)
    check(r["tri_exact"] and r["mat_exact"], "brute kernel: tri and mat "
                                             "exact")
    check(r["frac_within_tol"] >= NEED_FRAC,
          f"brute kernel: {r['frac_within_tol']:.5f} of rays within "
          f"{PIXEL_TOL} (need {NEED_FRAC})")
    check(0.05 * BRUTE_RAYS <= r["hits"] < BRUTE_RAYS, "brute kernel: a "
          "share of the rays hit")
    return r


def probe_entry(name, wrapper, replaces, launches, records) -> dict:
    """The kernels-line entry of a probe kernel, from the probe phase's
    first line for it (trav also gives its global-memory and scheduled
    forms)."""
    r = next(x for x in records if x["kernel"] == name)
    size = {k: v for k, v in r.items() if k in ("B", "R", "T", "P", "K", "C",
                                                "dtype", "variant", "table",
                                                "n_bins")}
    e = dict(name=name, route="cuda",
             source=f"ray_tracer_2_tpu_torch/csrc/{wrapper.source.name}",
             replaces=replaces, launches=launches[name],
             launches_per_frame=0.0,
             launched_as="probe entry point (python3 -m "
                         "ray_tracer_2_tpu_torch.probes)",
             max_abs_err=r["max_abs_err"], ms=r["device_ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"],
             ops=r["ops"], bytes=r["bytes"], size=size)
    if name == "trav":
        g = next(x for x in records if x["kernel"] == "trav"
                 and x.get("table") == "global")
        s = next(x for x in records if x["kernel"] == "trav_sched")
        e["global_table"] = dict(ms=g["device_ms"], bound_ms=g["bound_ms"])
        e["sched"] = dict(launches=launches["trav_sched"], ms=s["device_ms"],
                          plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                          bound_by=s["bound_by"],
                          max_abs_err=s["max_abs_err"], B=s["B"], T=s["T"])
    return e


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
    from ray_tracer_2_tpu_torch.kernels.cuda_build import build_all, \
        ptxas_lines
    from ray_tracer_2_tpu_torch.kernels.megakernel import (
        CUDA_MEGAKERNEL, brute_instances, render_plain,
    )
    from ray_tracer_2_tpu_torch.kernels.spheres import (
        CUDA_SPHERES, render_spheres_plain,
    )
    from ray_tracer_2_tpu_torch.probes import load_all
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
    probes = load_all()
    from ray_tracer_2_tpu_torch.probes.trav import TRAV_SCHED
    probe_wrappers = [w for w, _ in probes.KERNELS.values()] + [TRAV_SCHED]
    build_all(*kernels, *probe_wrappers)
    for k in {k.source: k for k in (*kernels, *probe_wrappers)}.values():
        emit(phase="build", source=k.source.name,
             nvcc_seconds=k.build_seconds,
             ptxas=ptxas_lines(k.build_log))
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
    room2_cmp = check_cases(
        [(small_name, room2_small, SMALL_W, SMALL_H, 0),
         (small_name, room2_small, SMALL_W, SMALL_H, BOUNCES),
         ("room2_scene", room2, W, H, 0),
         ("room2_scene", room2, W, H, BOUNCES),
         ("instances_scene", insts, SMALL_W, SMALL_H, 0),
         ("instances_scene", insts, SMALL_W, SMALL_H, BOUNCES),
         ("instances_scene", insts, W, H, BOUNCES)],
        CUDA_MEGAKERNEL, render_plain, kernel="megakernel")[3]
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

    # ---- 7. the probes ------------------------------------------------------
    zero_counts()
    for w in probe_wrappers:
        w.reset_counts()
    t0 = time.perf_counter()
    ctx = probes.Ctx(device=torch.device("cuda", 0), seed=0, smoke=True,
                     card=card)
    check(probes.run(ctx, probes.kernel_probes()), "every probe ran and "
          "matched its plain version")
    probe_launches = {name: w.launches for name, (w, _) in
                      probes.KERNELS.items()}
    probe_launches["trav_sched"] = TRAV_SCHED.launches
    for name, n in probe_launches.items():
        check(n > 0, f"probe kernel {name} launched")
    for r in ctx.records:
        check(r["plain_equal"] is True, f"probe {r['probe']} bit-equal to "
                                        "its plain version")
    emit(phase="probes", probes=len(ctx.records),
         seconds=time.perf_counter() - t0, launches=probe_launches,
         card=card)
    check(CUDA_MEGAKERNEL.launches == CUDA_SPHERES.launches == 0,
          "no render kernel launched by the probes")

    # bounds from this run's counted work on the timed 1080p cells; no one
    # PyTorch call computes a path-traced frame or a closest hit over a
    # triangle table, so library_ms is null
    main_b = megakernel_bound(main_scene, main_cmp)
    room2_b = megakernel_bound(room2, room2_cmp)
    sph_b = spheres_bound(rballs, sph_cmp)
    emit(kernels=[
        dict(name="megakernel", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/megakernel.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_boundary.py:236",
             launches=launches, launches_per_frame=launches / FRAMES,
             max_abs_err=main_cmp["max_abs_err"],
             ms=main_cmp["kernel_ms"], plain_ms=main_cmp["plain_ms"],
             bound_ms=main_b["bound_ms"], bound_by=main_b["bound_by"],
             library_ms=None, ops=main_b["ops"], bytes=main_b["bytes"],
             lane_occupancy=main_cmp["lane_occupancy"],
             room2=dict(launches_per_frame=room2_launches / FRAMES,
                        ms=room2_cmp["kernel_ms"],
                        plain_ms=room2_cmp["plain_ms"],
                        max_abs_err=room2_cmp["max_abs_err"],
                        lane_occupancy=room2_cmp["lane_occupancy"],
                        **room2_b)),
        dict(name="spheres", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/spheres.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_spheres.py:149",
             launches=sph_launches, launches_per_frame=sph_launches / FRAMES,
             max_abs_err=sph_cmp["max_abs_err"],
             ms=sph_cmp["kernel_ms"], plain_ms=sph_cmp["plain_ms"],
             bound_ms=sph_b["bound_ms"], bound_by=sph_b["bound_by"],
             library_ms=None, ops=sph_b["ops"], bytes=sph_b["bytes"],
             lane_occupancy=sph_cmp["lane_occupancy"]),
        # on the render path the brute.cuh loop runs inside the
        # megakernel: launches are the room2 launches whose device counts
        # show it ran; the numbers are the standalone kernel's check
        dict(name="brute", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/brute.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_brute.py:32",
             launches=brute_launches, launches_per_frame=0.0,
             launched_as="brute.cuh loop in megakernel.cu's segment "
                         "prepass, counted on the device",
             prepass_calls=brute_calls,
             standalone_launches_in_check=brute_check_launches,
             max_abs_err=brute_cmp["max_abs_err"],
             ms=brute_cmp["kernel_ms"], plain_ms=brute_cmp["plain_ms"],
             bound_ms=brute_cmp["bound_ms"], bound_by=brute_cmp["bound_by"],
             library_ms=None, ops=brute_cmp["ops"],
             bytes=brute_cmp["bytes"]),
        *[probe_entry(name, w, replaces, probe_launches, ctx.records)
          for name, (w, replaces) in probes.KERNELS.items()]])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
