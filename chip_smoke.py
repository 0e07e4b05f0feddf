#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (the
three render kernels and the four probe sources, one nvcc each, side by
side) and holds each against its plain PyTorch
version on the card. Then it drives four paths through
``Renderer.render`` at 1920x1080, 5 bounces, and checks that every frame
went through the path's kernel and no other:

* the main path — ``render_persistent`` -> ``csrc/megakernel.cu`` — on the
  80,000-triangle headline scene;
* the small-scene path — ``render_spheres`` -> ``csrc/spheres.cu`` — on
  ``random_balls`` (485 spheres, glass, specular);
* the sphere-scene path — the same scene with antialias, which the
  small-scene path does not take: ``render_persistent`` ->
  ``csrc/megakernel.cu``, its dense sphere loop in the shared-term form;
* the room2 path — ``render_persistent`` -> ``csrc/megakernel.cu``, whose
  segment prepass runs the brute-force loop of ``csrc/brute.cuh`` (the
  loop of ``csrc/brute.cu``; the kernel counts its calls on the device) —
  on ``room2_scene`` (two instances of one shared 80,000-triangle soup, a
  16-triangle brute-force group, a glass sphere, depth of field).

Next-event estimation (``RenderParams.nee``) goes through the megakernel's
NEE forms: they are held against ``render_plain(nee=True)`` on ``room``
(the shadow ray tested inline, mode 1; and forced into shadow segments,
mode 2, which must give the same image), ``balls`` (a sphere light, cone
sampling), room2 (shadow segments through both instances) at 128x72 and at
1920x1080, and ``sunlit_balls`` with the sphere BVH. The ``nee_path`` phase
renders room2 at 1080p through ``Renderer.render`` with ``nee=True``; then
``room`` is rendered to 1,024 samples a pixel with and without NEE through
``Renderer.render`` (seconds, image means, per-sample variance).

Scenes from asset files and textures (``scenes.sponza``, ``bugatti``: the
procedural substitutes of their absent OBJ files) go through the
megakernel's forms as they stand, and textured scenes through its textured
forms (general, glass, tables in global memory; one for each way spheres
are tested, with and without NEE). Each textured form is held against
``render_plain`` on at least one cell at 128x72: ``texture_test``'s sphere
pulled back with a seeded 512 x 256 image (bounces 0, 1, 5),
``textured_atrium_scene(size=64)`` (every material textured) and with one
material in ten textured, the normal-map quad with normal maps off and on
(the images must differ), a textured ``room`` (NEE mode 1) and the textured
atrium with NEE (mode 2), textured spheres among ``random_balls`` and
``sunlit_balls`` (the dense fast loop and the sphere BVH, with and without
NEE); ``bugatti`` and ``sponza`` take the untextured forms. The
``sponza_path`` phase holds ``sponza()`` (41,424 triangles, a quad light,
an emissive sphere) at 1080p, without and with NEE, against the plain
version, then renders it so through ``Renderer.render``; ``textured_path`` renders ``textured_atrium_scene(size=1024)`` (the
same geometry, ten 1024 x 1024 images: a 168 MB atlas) at 1080p with NEE,
after holding that frame's kernel against its plain version.

The megakernel is also held against its plain version on
``instances_scene``, where four instances of two shared tables take 38%
of the primary rays, and on the sphere-heavy scenes: ``random_balls`` with
antialias through the dense fast loop and through the sphere BVH,
``random_balls(half=24)`` (2,305 spheres: the sphere BVH by its size) and
``groups_scene(5)`` (tables past the shared-memory budget, read from global
memory).

The debug modes 1-7 (``csrc/debug.cu``: one unjittered primary ray a
pixel, the megakernel's segment hit from ``csrc/trace.cuh``, a colour per
mode) are held against their plain version in every mode
(``debug_kernel_vs_plain``: the main path's scene at 1920x1080; ``room``,
``metal``, ``random_balls`` with the sphere BVH, ``sponza()``, the
normal-map quad and the texture sphere at 128x72; colours of modes 1-4 on
NEED_FRAC of pixels within PIXEL_TOL, modes 5-7 equal, the per-ray counts
of child boxes and triangles tested equal), then driven through
``Renderer.render`` on ``sponza()`` at 1080p (``debug_path``: one debug
launch a frame, no megakernel launch). The README's two entry points run
on the card: ``engine_path`` drives ``Engine(1920, 1080,
initial_scene=SceneName.SPONZA)`` (the scene loaded in the background,
still frames, a camera move through the controller at 960x540 and one
bounce, still frames again; the first still frame after the move must be
bit-equal to a fresh scene rendered at that pose), and ``cli_path`` runs
``python3 -m ray_tracer_2_tpu_torch --scene sponza --spp 16`` at 1080p
straight through, stopped at 8 with ``--checkpoint`` and resumed, and with
``--batch 4``: the three checkpoints' framebuffers must be bit-equal.

Live scene edits and the browser viewer (``edit_path``, ``viewer_path``):
each of five edits (a sphere dragged on ``random_balls`` with the sphere
BVH, a material colour and a glass toggle on ``sponza()``, room2's box and
light moved with NEE on, a sphere moved on ``metal``) is made on a scene
whose kernel tables a frame has built, and the edited scene's kernel frame
is held bit-equal to its plain version at 128x72 (segments, visits, every
pixel); then each edit is timed at 1080p with the frame after it
(``Renderer.render``; launches == frames, through the path's own kernel).
``ViewerServer`` on ``sponza()`` at 960x540 serves over localhost: ``/state``,
a PNG from ``/frame.png``, the PNG push stream read for four seconds
(frames a second, bytes), one ``/ws`` input, one ``edit_entity`` and the E
hotkey (frames through ``csrc/debug.cu``), then a clean shutdown; PNG
encode ms and ``Engine``'s frame time on the same scene and size.

Multi-card rendering (``sharded_path``; ``parallel/sharding.py``) runs on
this one card over meshes that name it four times: row tiles through each
kernel's row window (``spheres.cu``, the megakernel with and without NEE,
``debug.cu``), a sample round and the 2 x 2 mesh at 1080p, ``Engine`` on
``sponza()`` with a checkpoint and a restore; every frame bit-equal to the
single-device frame it stands for, one launch a tile. It prints the 4-tile
1080p frame's ms beside the single frame's, and the device count (on a
host with several cards, the default mesh's frame across them). The twin
of ``__graft_entry__.py`` (``graft_entry``: one progressive step, then
the multi-card dry run) runs on the card too.

Both render kernels are persistent: lanes refill from a pixel cursor and
count their own work on the device. Each comparison also holds the
megakernel's interior-row, leaf and child-box visits equal to the plain
version's, and reports lane occupancy (active lanes over 32 x turns of the
lane loop) beside what one thread per pixel would have had. The kernels
line gives each kernel's bound: the larger of its operations, counted in
this run, over the card's float32 peak and its bytes over the memory rate;
and, as ``bound_nofma_ms``, the same with the operations over half that
peak, which is what code compiled without contraction (``--fmad=false``,
every kernel here) can execute.

The brute-force kernel is held against its plain version on 2,073,600 rays
x 256 triangles, on a 600-triangle table (three staged chunks) and on the edge-case list of
``kernels/brute_cases.py`` (duplicates, degenerate triangles, parallel
rays, origins on the plane, hits on edges and vertices, culled against
two-sided rows, table sizes around 16, 256 and 600).

Then the probe phase runs every probe kernel of ``probes/`` (the
hand-written Hopper counterparts of the TPU probe scripts
``scripts/probe_{trav,packet,r2,lut}.py``) once, at the first of its
script's sizes (``mxu_leaf_dense`` at both), through the runner of
``python3 -m ray_tracer_2_tpu_torch.probes``, and holds each bit-equal to
its plain version on the card: output, final index and checksum. The
tensor-core form of ``mxu_leaf_dense`` sums in the unit's own order and is
held to its stated gate instead (``probes/lut.py:mma_gate``).

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

import numpy as np
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
OPS_SPHERE_FAST = 30    # the shared-term formula (both kernels), per sphere
OPS_SPHERE_LEAF = 8 * 33  # megakernel.cu traverse, per leaf of 8 spheres
OPS_TRI = 49            # spheres.cu triangle test, per triangle
OPS_BRUTE = 47          # brute.cuh test_row, per ray-triangle pair (what
                        # depends on the triangle alone is staged once)
OPS_INSTANCE = 60       # megakernel.cu instance ray, limit, merge
OPS_SEGMENT = 160       # camera ray share, shading, roulette per segment
OPS_NEE_TRI = 62        # megakernel.cu sample_light, a triangle light
OPS_NEE_SPHERE = 126    # megakernel.cu sample_light, a sphere light
# (each plus one compare per light but the last, for the pick)
OPS_TAP = 76            # megakernel.cu sample_quads, per texel quad fetched
OPS_DEBUG_PIXEL = 60    # debug.cu camera ray, hit normal and UV, colour
TAP_BYTES = 16          # one int4 texel quad a tap
SPP = 1024              # samples a pixel of the time-to-quality phase
SPP_VAR_FRAMES = 32     # frames whose deltas give the per-sample variance


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


T0 = time.perf_counter()


def emit(**obj) -> None:
    """Print one JSON line; a phase line also says how many seconds into
    the run it was printed (``t``)."""
    if "phase" in obj:
        obj["t"] = round(time.perf_counter() - T0, 2)
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


def compare(scene, width, height, bounces, kernel, plain, **options):
    """Kernel vs plain version on the same scene and frame (``options``:
    further render options, e.g. antialias); the kernel is timed over
    repeated launches after the compared one, the plain version on the
    compared call. The kernel's device counts are those of the compared
    launch."""
    kw = dict(width=width, height=height, bounces=bounces, rays_per_pixel=1,
              skybox=True, **options)
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
    for k in ("rows", "leaves", "boxes", "brute_calls", "shadow_rays"):
        if k in kc:
            r[f"{k}_kernel"] = kc[k]
            if k in pc:
                r[f"{k}_plain"] = pc[k]
    if "texture_taps" in pc:    # the kernel does not count its taps
        r["texture_taps_plain"] = pc["texture_taps"]
    return r


def check_cases(cases, launch, plain, **tags):
    """``compare`` on each (scene name, scene, width, height, bounces[,
    render options]) case, held to exact segments, NEED_FRAC of pixels
    within PIXEL_TOL and >= 10% of pixels lit. Returns the results in
    order."""
    results = []
    for name, scene, w, h, b, *options in cases:
        r = compare(scene, w, h, b, launch, plain,
                    **(options[0] if options else {}))
        emit(phase="kernel_vs_plain", scene=name, need_frac=NEED_FRAC,
             **tags, **r)
        where = f"{name} at bounces={b} ({w}x{h})"
        check(r["segments_kernel"] == r["segments_plain"],
              f"exact segments, {where}")
        for k in ("rows", "leaves", "boxes", "shadow_rays"):
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


def megakernel_bound(scene, r, nee_mode: int = 0, taps: int = 0) -> dict:
    """Bound of the megakernel on a compared cell: its counted child boxes,
    leaves and segments (each segment tests every dense sphere, by the
    formula the scene's sphere count picks, and every brute-force triangle,
    and transforms the ray into every instance), against its tables read
    once and the image written once. A leaf counts as 8 triangles, or, in a
    scene whose only tree is the sphere BVH, as 8 spheres. The kernel's
    counts do not tell the two kinds of leaf apart, so a scene with both
    kinds of tree has no bound here and raises. With next-event estimation
    each counted shadow ray adds a light sample (the cheaper kind among the
    scene's lights) and, in mode 1, a prepass (its spheres, brute-force
    triangles and their instances); in mode 2 it is a counted segment that
    shades nothing. Each of ``taps`` texel quads fetched (the plain
    version's count) adds its sampling arithmetic and its 16 bytes."""
    from ray_tracer_2_tpu_torch.kernels.intersect import SPHERE_FAST_MIN
    from ray_tracer_2_tpu_torch.kernels.megakernel import (
        brute_instances, bvh_instances, dense_spheres,
    )
    from ray_tracer_2_tpu_torch.probes.common import bound, nbytes
    if scene.sphere_bvh_root >= 0 and bvh_instances(scene):
        raise ValueError("sphere and triangle leaves are counted together: "
                         "no bound for a scene with both kinds of tree")
    brute_tris = sum(scene.inst_spans[i][2] for i in brute_instances(scene))
    dense = dense_spheres(scene)
    prepass = (dense * (OPS_SPHERE_FAST if dense >= SPHERE_FAST_MIN
                        else OPS_SPHERE) + brute_tris * OPS_BRUTE
               + len(brute_instances(scene)) * OPS_INSTANCE)
    per_seg = prepass + (scene.n_instances - len(brute_instances(scene))) \
        * OPS_INSTANCE + OPS_SEGMENT
    ops_leaf = OPS_SPHERE_LEAF if scene.sphere_bvh_root >= 0 else OPS_LEAF
    ops = (r["boxes_kernel"] * OPS_BOX + r["leaves_kernel"] * ops_leaf
           + r["segments_kernel"] * per_seg)
    shadow = r.get("shadow_rays_kernel", 0) if nee_mode else 0
    if shadow:
        kinds = {int(row[0]) for row in scene.lights}
        sample = min(OPS_NEE_SPHERE if k else OPS_NEE_TRI for k in kinds) \
            + len(scene.lights) - 1
        ops += shadow * (sample + (prepass if nee_mode == 1
                                   else -OPS_SEGMENT))
    ops += taps * OPS_TAP
    return bound(ops, nbytes(scene.wide_rows, scene.tri_attr, scene.mat_rows)
                 + r["width"] * r["height"] * 16 + taps * TAP_BYTES)


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


def brute_record(got: dict, ref: dict) -> dict:
    """The kernel's record against the plain version's, field by field."""
    fields = ("dst", "u", "v", "det")
    err = torch.stack([(got[k] - ref[k]).abs() for k in fields]).amax(dim=0)
    hit = ref["tri"] >= 0
    return dict(hits=int(hit.sum()),
                tri_exact=bool((got["tri"] == ref["tri"]).all()),
                mat_exact=bool((got["mat"] == ref["mat"]).all()),
                bit_equal=all(torch.equal(got[k], ref[k]) for k in fields),
                frac_within_tol=float((err < PIXEL_TOL).float().mean()),
                max_abs_err=float(err[hit].max()) if bool(hit.any()) else 0.0)


def check_brute(r: dict, what: str) -> None:
    check(r["tri_exact"] and r["mat_exact"], f"brute kernel, {what}: tri and "
                                             "mat exact")
    check(r["frac_within_tol"] >= NEED_FRAC,
          f"brute kernel, {what}: {r['frac_within_tol']:.5f} of rays within "
          f"{PIXEL_TOL} (need {NEED_FRAC})")


def compare_brute(seed: int = 0):
    """``rt2_brute_intersect`` against ``brute_force_intersect_plain`` on
    BRUTE_RAYS rays from ``seed`` (origins in a 3-unit box around the
    group, directions uniform): the 256-triangle group, a 600-triangle
    table (three staged chunks), and every edge case of
    ``kernels/brute_cases.py``. Returns the 256-triangle result."""
    import numpy as np
    from ray_tracer_2_tpu_torch.kernels.brute import (
        CUDA_BRUTE, brute_force_intersect,
        brute_force_intersect_plain, kernel_record, pack_brute_table,
    )
    from ray_tracer_2_tpu_torch.kernels.brute_cases import (
        edge_cases, table_scene,
    )
    from ray_tracer_2_tpu_torch.kernels.cuda_build import ptxas_summary
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
    kernel_ms(lambda: CUDA_BRUTE(rays, table, count), reps=20)  # warm clocks
    k_ms = kernel_ms(lambda: CUDA_BRUTE(rays, table, count), reps=20)
    ref, p_ms = timed(lambda: brute_force_intersect_plain(
        scene, o, d, tri_off, count))
    culled = table[:, 10] > 0.5
    r = dict(rays=BRUTE_RAYS, triangles=count,
             culled=int(culled.sum()), two_sided=int((~culled).sum()),
             **brute_record(kernel_record(out, tri_off), ref),
             kernel_ms=k_ms, plain_ms=p_ms,
             rays_per_thread=1, ptxas=ptxas_summary(CUDA_BRUTE.build_log),
             g_pairs_per_s=BRUTE_RAYS * count / k_ms / 1e6,
             **bound(BRUTE_RAYS * count * OPS_BRUTE,
                     nbytes(rays, table, out)))
    emit(phase="kernel_vs_plain", kernel="brute", need_frac=NEED_FRAC, **r)
    check_brute(r, "256 triangles")
    check(0.05 * BRUTE_RAYS <= r["hits"] < BRUTE_RAYS, "brute kernel: a "
          "share of the rays hit")
    # ---- three staged chunks: the 600-triangle soup of the case list
    cases = {c.name: c for c in edge_cases()}
    big = table_scene(cases["soup_600"], "cuda")
    big_table = pack_brute_table(big, 0, 600)
    big_out = CUDA_BRUTE(rays, big_table, 600)
    big_ms = kernel_ms(lambda: CUDA_BRUTE(rays, big_table, 600), reps=10)
    big_ref, big_p_ms = timed(lambda: brute_force_intersect_plain(
        big, o, d, 0, 600))
    rb = dict(rays=BRUTE_RAYS, triangles=600,
              **brute_record(kernel_record(big_out), big_ref),
              kernel_ms=big_ms, plain_ms=big_p_ms,
              ms_per_256=big_ms * 256 / 600,
              **bound(BRUTE_RAYS * 600 * OPS_BRUTE,
                      nbytes(rays, big_table, big_out)))
    emit(phase="kernel_vs_plain", kernel="brute", table="soup_600",
         need_frac=NEED_FRAC, **rb)
    check_brute(rb, "600 triangles")
    check(rb["hits"] > 0.05 * BRUTE_RAYS, "brute kernel, 600 triangles: a "
                                          "share of the rays hit")
    # ---- the edge cases the plain version is pinned on (CPU tests)
    edge = {}
    for name, case in cases.items():
        ns = table_scene(case, "cuda")
        co = torch.from_numpy(case.origin).cuda()
        cd = torch.from_numpy(case.direction).cuda()
        got = brute_force_intersect(ns, co, cd, 0, case.count)
        want = brute_force_intersect_plain(ns, co, cd, 0, case.count)
        e = dict(rays=len(case.origin), triangles=case.count,
                 **brute_record(got, want))
        check_brute(e, f"edge case {name}")
        check(e["hits"] >= case.min_hits, f"edge case {name}: "
                                          f"{e['hits']} rays hit")
        edge[name] = e
    emit(phase="kernel_vs_plain", kernel="brute", edge_cases=edge)
    return r


def compare_debug(name, scene, width, height, modes=range(1, 8),
                  plain_mode=None):
    """``csrc/debug.cu`` against its plain version on one cell in every
    mode of ``modes`` (the plain colours of all of them from one hit
    record): modes 1-4 held to NEED_FRAC of pixels within PIXEL_TOL, 5-7
    equal, the per-ray counts (child boxes, triangles tested) equal in
    every mode. The kernel is timed in mode 1 over repeated launches;
    with ``plain_mode`` the plain version is also timed alone in that
    mode. Returns the cell's record."""
    from ray_tracer_2_tpu_torch.kernels.debug import CUDA_DEBUG, \
        render_debug_plain
    kw = dict(width=width, height=height, debug_scale=100.0)
    (plain, pc), p_all_ms = timed(lambda: render_debug_plain(
        scene, debug_mode=modes[0], modes=modes, **kw))
    where = f"debug {name} ({width}x{height})"
    per_mode = {}
    for m in modes:
        img, kc = CUDA_DEBUG(scene, debug_mode=m, **kw)
        err = (img - plain[m]).abs().amax(dim=-1)
        r = dict(frac_within_tol=float((err < PIXEL_TOL).float().mean()),
                 max_abs_err=float(err.max()),
                 bit_equal=bool(torch.equal(img, plain[m])),
                 counts_equal=bool(torch.equal(kc, pc)))
        per_mode[m] = r
        check(bool(torch.isfinite(img).all()), f"{where}, mode {m}: finite")
        check(r["counts_equal"], f"{where}, mode {m}: per-ray box and "
                                 "triangle counts equal")
        if m <= 4:
            check(r["frac_within_tol"] >= NEED_FRAC,
                  f"{where}, mode {m}: {r['frac_within_tol']:.5f} of pixels "
                  f"within {PIXEL_TOL} (need {NEED_FRAC})")
        else:
            check(r["bit_equal"], f"{where}, mode {m}: colours equal")
    hit = float((plain[modes[0]][..., 3] > 0).float().mean()) \
        if modes[0] <= 4 else None
    k_ms = kernel_ms(lambda: CUDA_DEBUG(scene, debug_mode=modes[0], **kw),
                     reps=10)
    out = dict(width=width, height=height, modes=per_mode, kernel_ms=k_ms,
               plain_all_modes_ms=p_all_ms, hit_share=hit,
               boxes=int(pc[..., 0].sum()), tris=int(pc[..., 1].sum()),
               max_abs_err=max(r["max_abs_err"] for r in per_mode.values()))
    if plain_mode is not None:
        _, out["plain_ms"] = timed(lambda: render_debug_plain(
            scene, debug_mode=plain_mode, **kw))
    emit(phase="debug_kernel_vs_plain", scene=name, need_frac=NEED_FRAC,
         **out)
    return out


def debug_bound(scene, r) -> dict:
    """Bound of the debug kernel on a compared cell: its counted child boxes
    and triangle tests (only the leaves' real triangles, so a lower bound),
    and per pixel the dense spheres, one instance ray each, the camera ray
    and the colour; its tables read once, colours and counts written
    once."""
    from ray_tracer_2_tpu_torch.kernels.megakernel import dense_spheres
    from ray_tracer_2_tpu_torch.probes.common import bound, nbytes
    pixels = r["width"] * r["height"]
    per_pixel = (OPS_DEBUG_PIXEL + dense_spheres(scene) * OPS_SPHERE
                 + scene.n_instances * OPS_INSTANCE)
    return bound(r["boxes"] * OPS_BOX + r["tris"] * OPS_BRUTE
                 + pixels * per_pixel,
                 nbytes(scene.wide_rows, scene.tri_attr, scene.mat_rows)
                 + pixels * (16 + 8))


def run_cli(args, cwd) -> tuple[float, str]:
    """``python3 -m ray_tracer_2_tpu_torch`` with ``args`` in a subprocess
    from the checkout's root; returns (wall seconds, its log). Raises on a
    non-zero exit."""
    import os
    env = dict(os.environ, PYTHONPATH=str(cwd))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "ray_tracer_2_tpu_torch",
                          *args], cwd=cwd, env=env, capture_output=True,
                         text=True)
    sec = time.perf_counter() - t0
    check(res.returncode == 0, f"cli {' '.join(args)}: exit "
                               f"{res.returncode}\n{res.stderr[-2000:]}")
    return sec, res.stderr


def probe_entry(name, wrapper, replaces, launches, records) -> dict:
    """The kernels-line entry of a probe kernel, from the probe phase's
    first line for it (trav also gives its global-memory and scheduled
    forms)."""
    r = next(x for x in records if x["kernel"] == name)
    size = {k: v for k, v in r.items() if k in ("B", "R", "T", "P", "K", "C",
                                                "dtype", "variant", "table",
                                                "n_bins", "form")}
    e = dict(name=name, route="cuda",
             source=f"ray_tracer_2_tpu_torch/csrc/{wrapper.source.name}",
             replaces=replaces, launches=launches[name],
             launches_per_frame=0.0,
             launched_as="probe entry point (python3 -m "
                         "ray_tracer_2_tpu_torch.probes)",
             max_abs_err=r["max_abs_err"], ms=r["device_ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], bound_nofma_ms=r["bound_nofma_ms"],
             library_ms=r["library_ms"], ops=r["ops"], bytes=r["bytes"],
             size=size)
    for k in ("kernel_only_ms", "host_us", "library_kernel_only_ms",
              "library_host_us", "gate"):
        if r.get(k) is not None:
            e[k] = r[k]
    if name.startswith("mxu_leaf_dense"):   # one entry per form and size
        e["lines"] = [
            {k: x.get(k) for k in ("dtype", "form", "T", "device_ms",
                                   "kernel_only_ms", "bound_ms",
                                   "bound_nofma_ms", "plain_equal", "gate")}
            for x in records if x["kernel"] == name]
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


def whole(framebuffer) -> torch.Tensor:
    """A renderer's framebuffer as one tensor on its home device: gathered
    from its row blocks where it lies on a mesh (``ShardedFramebuffer``)."""
    from ray_tracer_2_tpu_torch.parallel import ShardedFramebuffer
    return framebuffer.gather() \
        if isinstance(framebuffer, ShardedFramebuffer) else framebuffer


def time_to_spp(renderer, scene, params, spp=SPP):
    """``spp`` progressive frames of one sample a pixel through
    ``renderer.render``; returns (seconds from the first frame to the last
    one's end, mean of the final image's rgb over all pixels)."""
    renderer.synchronize()
    t0 = time.perf_counter()
    for f in range(spp):
        renderer.render(scene, dataclasses.replace(params, frames=f))
    renderer.synchronize()
    sec = time.perf_counter() - t0
    fb = whole(renderer.framebuffer)
    check(bool(torch.isfinite(fb).all()), "converged image finite")
    return sec, float(fb[..., :3].double().mean())


def sample_variance(renderer, scene, params,
                    frames=SPP_VAR_FRAMES) -> float:
    """Per-sample variance of the rgb of each pixel, averaged over the
    image, from the ``frames`` first frames of ``renderer.render``: each
    frame's own sample is read off the accumulation (frame f's buffer times
    f + 1 less frame f - 1's times f, in float64)."""
    s1 = s2 = prev = None
    for f in range(frames):
        fb = whole(renderer.render(scene,
                                   dataclasses.replace(params, frames=f)))
        fb = fb[..., :3].double()
        raw = fb if f == 0 else fb * (f + 1) - prev * f
        s1 = raw if s1 is None else s1 + raw
        s2 = raw * raw if s2 is None else s2 + raw * raw
        prev = fb.clone()
    return float(((s2 - s1 * s1 / frames) / (frames - 1)).mean())


def drive(renderer, scene, params, frames=FRAMES):
    """``frames`` progressive frames through ``renderer.render``, frames 2
    and on timed on the host clock after a synchronise of every device the
    renderer uses. Returns (seconds of the timed frames, segments of each
    frame)."""
    segs = []
    t_start = None
    for f in range(frames):
        if f == 2:
            renderer.synchronize()
            t_start = time.perf_counter()
        renderer.render(scene, dataclasses.replace(params, frames=f))
        segs.append(renderer.last_segments)
    renderer.synchronize()
    dt = time.perf_counter() - t_start
    fb = renderer.read_framebuffer()
    check(bool(np.isfinite(fb).all()), "framebuffer finite")
    check(float(abs(fb).max()) > 0.0, "framebuffer not all zero")
    segs = [int(s) for s in segs]
    check(sum(segs) >= params.width * params.height * frames,
          "at least one segment per pixel")
    return dt, segs


def frame_ms(renderer, scene, params, n=10) -> float:
    """Host ms a progressive frame through ``renderer.render``: one frame,
    then ``n`` more between two synchronisations of every device the
    renderer uses."""
    renderer.render(scene, params)
    renderer.synchronize()
    t0 = time.perf_counter()
    for f in range(1, n + 1):
        renderer.render(scene, dataclasses.replace(params, frames=f))
    renderer.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def tile_split(scene, fkw, tiles=4, frames=5) -> dict:
    """Where a row-tiled frame's device time goes, from CUDA events on the
    current stream: before and after each tile's ``render_sample`` (its
    kernel with the wrapper's set-up) and after its blend into the
    framebuffer, for the frame as one tile and as ``tiles`` row tiles one
    after another, frames 1 to ``frames``. Per layout: each tile's render
    ms (mean over the frames) and its segments (last frame), the blends'
    ms, the gaps between one tile's blend and the next tile's render (the
    card waiting for the host) and the whole frame's ms."""
    from ray_tracer_2_tpu_torch.engine.renderer import (
        blend, blend_weight, render_sample,
    )
    h, w = fkw["height"], fkw["width"]
    out = {}
    for n in (1, tiles):
        block = h // n
        fb = torch.zeros((h, w, 4), dtype=torch.float32, device="cuda")
        render, blends, gaps, whole_ms = [], [], [], []
        for f in range(1, frames + 1):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(3 * n)]
            segs = []
            for i in range(n):
                ev[3 * i].record()
                sample, sg = render_sample(scene, f, row_start=i * block,
                                           rows=block, **fkw)
                ev[3 * i + 1].record()
                blend(fb[i * block:(i + 1) * block], sample, blend_weight(f))
                ev[3 * i + 2].record()
                segs.append(sg)
            torch.cuda.synchronize()
            render.append([ev[3 * i].elapsed_time(ev[3 * i + 1])
                           for i in range(n)])
            blends.append(sum(ev[3 * i + 1].elapsed_time(ev[3 * i + 2])
                              for i in range(n)))
            gaps.append(sum(ev[3 * i - 1].elapsed_time(ev[3 * i])
                            for i in range(1, n)))
            whole_ms.append(ev[0].elapsed_time(ev[-1]))
        tile_ms = [sum(r[i] for r in render) / frames for i in range(n)]
        out[f"tiles{n}"] = dict(
            render_ms=tile_ms, render_sum_ms=sum(tile_ms),
            segments=[int(x) for x in segs],
            blend_ms=sum(blends) / frames, gap_ms=sum(gaps) / frames,
            frame_ms=sum(whole_ms) / frames)
    return out


def auto_mesh_frames(scene, params, device="cuda"):
    """``Renderer()``'s default mesh on this host (``auto``: the distinct
    cards) beside one device, each through ``frame_ms``: the mesh, both
    ms a frame and whether the two final frames are bit-equal. None where
    the default adopts no mesh (one card)."""
    from ray_tracer_2_tpu_torch.engine.renderer import Renderer
    auto = Renderer(device=device)
    auto.ensure_framebuffer(params.width, params.height)
    if auto.mesh is None:
        return None
    one = Renderer(device=device, mesh=None)
    auto_ms = frame_ms(auto, scene, params)
    one_ms = frame_ms(one, scene, params)
    got = auto.read_framebuffer()
    check(bool(np.isfinite(got).all()), "auto mesh: framebuffer finite")
    return dict(mesh=[str(d) for d in auto.mesh.devices],
                auto_mesh_ms=auto_ms, one_device_ms=one_ms,
                bit_equal=got.tobytes() == one.read_framebuffer().tobytes())


def sharded_path(card, main_scene, room2_small, kernels, zero_counts) -> dict:
    """The multi-card layouts of ``parallel/sharding.py`` on the card, over
    meshes that name it several times (the one-card stand-in for several
    cards; the reference's tests force 8 host devices the same way): row
    tiles 4 x 1 (``metal`` through ``csrc/spheres.cu``, the main path's
    scene at 1080p and room2's small cell without and with NEE through the
    megakernel, the main path's scene in debug mode 1 through
    ``csrc/debug.cu``), each frame bit-equal to ``Renderer(mesh=None)``'s
    with equal segments and one launch a tile; a sample round over 4,
    bit-equal to the mean of the four single-device frames composed on the
    host in the same order; the 2 x 2 mesh, bit-equal to the composition of
    the reference's ``test_hybrid_mesh_matches_composed_single_device``;
    ``Engine`` on ``sponza()`` over the 4 x 1 mesh, checkpointed and
    restored bit-equal. Then the 4-tile 1080p main-path frame against the
    single frame, through ``Renderer.render``, and where its device time
    goes (``tile_split``); and, on a host with several cards, the default
    mesh's frame across them beside one card's, bit-equal to it
    (``auto_mesh_frames``)."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from ray_tracer_2_tpu_torch.config import DebugMode, RenderParams
    from ray_tracer_2_tpu_torch.engine import Engine
    from ray_tracer_2_tpu_torch.engine.checkpoint import (
        restore_engine, save_checkpoint,
    )
    from ray_tracer_2_tpu_torch.engine.renderer import (
        Renderer, blend_weight, render_sample,
    )
    from ray_tracer_2_tpu_torch.parallel import (
        auto_mesh, make_render_mesh, make_render_mesh2d,
        render_frame_hybrid_sharded, render_frame_spp_sharded,
        shard_framebuffer,
    )
    from ray_tracer_2_tpu_torch.scene import scenes
    from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
    from ray_tracer_2_tpu_torch.scene.scenes import SceneName
    n_cards = torch.cuda.device_count()
    check(n_cards > 1 or auto_mesh(H) is None,
          "one card: the default mesh adopts nothing")
    rows4 = make_render_mesh(devices=["cuda:0"] * 4)
    kw = dict(rays_per_pixel=1, skybox=True)
    out = dict(card=card, device_count=n_cards)

    def launched():
        return {k: w.launches for k, w in kernels.items()}

    # row tiles, 4 x 1: two progressive frames each
    metal = instantiate_scene(scenes.metal()).to("cuda")
    tiles = []
    for name, sc, w, h, opts, kname in (
            ("metal", metal, SMALL_W, SMALL_H, {}, "spheres"),
            ("main_path_scene", main_scene, W, H, {}, "megakernel"),
            ("room2_scene (12x12 soup)", room2_small, SMALL_W, SMALL_H, {},
             "megakernel"),
            ("room2_scene (12x12 soup), NEE", room2_small, SMALL_W, SMALL_H,
             dict(nee=True), "megakernel"),
            ("main_path_scene, debug mode 1", main_scene, W, H,
             dict(debug_mode=DebugMode.NORMALS), "debug")):
        single, sharded = Renderer(device="cuda", mesh=None), \
            Renderer(device="cuda", mesh=rows4)
        for f in range(2):
            p = RenderParams(width=w, height=h, bounces=BOUNCES, frames=f,
                             **opts)
            want = single.render(sc, p)
            zero_counts()
            got = sharded.render(sc, p)
            n = launched()
            check(n[kname] == 4 and sum(n.values()) == 4,
                  f"sharded {name}: one {kname} launch a tile: {n}")
            check(torch.equal(got.gather(), want),
                  f"sharded {name}, frame {f}: bit-equal to one device")
            check(int(sharded.last_segments) == int(single.last_segments),
                  f"sharded {name}, frame {f}: segments equal")
        tiles.append(dict(scene=name, width=w, height=h, kernel=kname,
                          tiles=4, launches_per_frame=4,
                          segments=int(sharded.last_segments),
                          bit_equal=True))
    out["row_tiles"] = tiles

    # a sample round over 4 at 1080p, round 1 (weight 4 / 8)
    fkw = dict(width=W, height=H, bounces=BOUNCES, **kw)
    fb = torch.zeros((H, W, 4), dtype=torch.float32, device="cuda")
    zero_counts()
    got, segs = render_frame_spp_sharded(main_scene, fb, 1, mesh=rows4,
                                         **fkw)
    n = launched()
    check(n["megakernel"] == 4 and sum(n.values()) == 4,
          f"sample round: four megakernel launches: {n}")
    samples = [render_sample(main_scene, 4 + j, **fkw) for j in range(4)]
    acc = samples[0][0].cpu().numpy()
    for smp, _ in samples[1:]:
        acc = acc + smp.cpu().numpy()
    four = np.float32(4)
    w = four / (np.float32(1) * four + four)
    want = np.zeros((H, W, 4), np.float32) * (np.float32(1) - w) \
        + (acc / four) * w
    check(got.cpu().numpy().tobytes() == want.tobytes(),
          "sample round: bit-equal to the host's mean of the four frames")
    check(int(segs) == sum(int(x) for _, x in samples),
          "sample round: segments summed")
    out["sample_round"] = dict(width=W, height=H, devices=4, frames=1,
                               segments=int(segs), bit_equal=True)

    # the 2 x 2 mesh at 1080p, round 2 (weight 1 / 3)
    mesh2 = make_render_mesh2d(2, 2, ["cuda:0"] * 4)
    fb = shard_framebuffer(torch.zeros((H, W, 4), dtype=torch.float32,
                                       device="cuda"), mesh2)
    zero_counts()
    got, segs = render_frame_hybrid_sharded(main_scene, fb, 2, mesh=mesh2,
                                            **fkw)
    n = launched()
    check(n["megakernel"] == 4 and sum(n.values()) == 4,
          f"2 x 2 mesh: four megakernel launches: {n}")
    samples = [render_sample(main_scene, 2 * 2 + j, **fkw) for j in range(2)]
    mean = (samples[0][0].cpu().numpy() + samples[1][0].cpu().numpy()) \
        / np.float32(2)
    w = blend_weight(2)
    want = np.zeros((H, W, 4), np.float32) * (np.float32(1) - w) + mean * w
    check(got.cpu().numpy().tobytes() == want.tobytes(),
          "2 x 2 mesh: bit-equal to the composed single-device frames")
    check(int(segs) == sum(int(x) for _, x in samples),
          "2 x 2 mesh: segments summed over both axes (each sample's row "
          "blocks make up its whole frame)")
    out["hybrid_2x2"] = dict(width=W, height=H, frames=2,
                             segments=int(segs), bit_equal=True)

    # Engine over the 4 x 1 mesh on sponza: still frames, a checkpoint, a
    # restore into a new engine's row blocks
    def engine():
        return Engine(W, H, initial_scene=SceneName.SPONZA,
                      block_on_initial_scene=True, device="cuda", mesh=rows4)

    zero_counts()
    eng = engine()
    with tempfile.TemporaryDirectory() as tmp:
        ck = Path(tmp) / "sharded.npz"
        for _ in range(3):
            eng.update(dt=0.016)
        host = eng.scene_manager.scene
        save_checkpoint(ck, eng.renderer.framebuffer, eng.params,
                        scene_name="Sponza", camera=host.camera)
        for _ in range(3):
            eng.update(dt=0.016, sync=True)
        n = launched()
        check(n["megakernel"] == 24 and sum(n.values()) == 24,
              f"engine on a mesh: 4 launches a frame in 6 frames: {n}")
        resumed = engine()
        restore_engine(resumed, ck)
        for _ in range(3):
            resumed.update(dt=0.016, sync=True)
        check(resumed.params.frames == eng.params.frames
              and resumed.renderer.read_framebuffer().tobytes()
              == eng.renderer.read_framebuffer().tobytes(),
              "engine on a mesh: restored and resumed bit-equal")
    blocks = [tuple(b.shape) for b in eng.renderer.framebuffer.blocks]
    for e in (eng, resumed):
        e.scene_manager.shutdown()
    out["engine"] = dict(scene="sponza()", width=W, height=H, frames=6,
                         blocks=blocks, resumed_bit_equal=True)

    # times: the 4-tile 1080p main-path frame against the single frame,
    # through Renderer.render, single / tiles / tiles / single
    params = RenderParams(width=W, height=H, bounces=BOUNCES)
    runs = {"single": [], "tiles4": []}
    for which in ("single", "tiles4", "tiles4", "single"):
        runs[which].append(frame_ms(Renderer(
            device="cuda", mesh=None if which == "single" else rows4),
            main_scene, params))
    out["main_path_1080p_ms"] = dict(
        single=runs["single"], tiles4=runs["tiles4"],
        tail_ms=sum(runs["tiles4"]) / 2 - sum(runs["single"]) / 2)
    out["main_path_1080p_split"] = tile_split(main_scene, fkw)
    cards = auto_mesh_frames(main_scene, params)
    check(cards is None or cards["bit_equal"],
          f"the default mesh across {n_cards} cards: bit-equal to one card")
    if cards is not None:
        out["cards"] = cards
    return out


def edit_cases(scenes, instantiate_host_scene):
    """The ``edit_path`` cells: (name, host scene on the card, render
    options, edit(host, tick)). Each edit is one tick of what the viewer
    does: a sphere dragged on ``random_balls`` with the sphere BVH (its
    rows rebuilt), a material colour and a glass toggle on ``sponza()``
    (the toggle repacks the cull flags of 41,424 triangles and changes the
    kernel's form), the room box of room2 (its light among its quads) moved
    with NEE on (the light table refreshed), a sphere moved on ``metal``
    (the small-scene kernel)."""
    from ray_tracer_2_tpu_torch.scene.material import MaterialFlag

    def host(definition, **kw):
        return instantiate_host_scene(definition, **kw).to("cuda")

    balls = host(scenes.random_balls(), sphere_bvh=True)
    big = balls.n_spheres - 1           # the last of the four large spheres
    c0 = balls.scene.sphere_pos[big].cpu().numpy().copy()
    sponza = host(scenes.sponza())
    part = sponza.inst_material_ids[0][0]
    flag0 = int(sponza.records[part].flag)
    glass = host(scenes.sponza())
    return [
        ("random_balls + sphere BVH, sphere drag", balls, {},
         lambda h, k: h.edit_sphere(big, centre=c0 + [0.0, 0.0,
                                                      0.02 * (k + 1)])),
        ("sponza(), material colour", sponza, {},
         lambda h, k: h.edit_material(part, color=(
             0.2 + 0.1 * (k % 5), 0.3, 0.8, 1.0))),
        ("sponza(), glass toggle", glass, {},
         lambda h, k: h.edit_material(part, flag=(
             int(MaterialFlag.GLASS) if k % 2 == 0 else flag0), ior=1.5)),
        ("room2_scene + NEE, room box moved", host(scenes.room2_scene()),
         dict(nee=True), lambda h, k: h.edit_instance_transform(
             2, pos=[0.0, 0.002 * (k + 1), 0.0])),
        ("metal, sphere move (spheres.cu)", host(scenes.metal()), {},
         lambda h, k: h.edit_sphere(1, centre=[0.05 * (k + 1), 0.0, -1.0])),
    ]


def ws_exchange(port: int, messages) -> list:
    """Send ``messages`` (dicts) over the viewer's /ws input channel, each
    followed by a ping, and return the pongs: each pong comes after its
    message was handled."""
    import base64
    import os
    import socket
    import struct
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        key = base64.b64encode(os.urandom(16)).decode()
        s.sendall(("GET /ws HTTP/1.1\r\nHost: localhost\r\n"
                   "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\n"
                   "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += s.recv(4096)
        check(resp.startswith(b"HTTP/1.1 101"), f"ws handshake: {resp[:40]}")

        def send(obj):
            data = json.dumps(obj).encode()
            check(len(data) < 126, "short ws message")
            mask = os.urandom(4)
            s.sendall(bytes([0x81, 0x80 | len(data)]) + mask + bytes(
                c ^ mask[i % 4] for i, c in enumerate(data)))

        def recv():
            hdr = s.recv(2)
            n = hdr[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", s.recv(2))[0]
            buf = b""
            while len(buf) < n:
                buf += s.recv(n - len(buf))
            return json.loads(buf)

        pongs = []
        for i, msg in enumerate(messages):
            send(msg)
            send({"ping": i})
            pongs.append(recv())
        return pongs
    finally:
        s.close()


def png_size(data: bytes) -> tuple:
    """(width, height) of a PNG, after checking its signature."""
    import struct
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "a PNG signature")
    return struct.unpack(">II", data[16:24])


def stream_frames(port: int, seconds: float) -> tuple:
    """Read the viewer's PNG push stream for ``seconds``: (parts
    received, bytes of the last part)."""
    import socket
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall(b"GET /stream.mpng HTTP/1.1\r\nHost: localhost\r\n\r\n")
    buf, parts, last, t_end = b"", 0, 0, time.perf_counter() + seconds
    try:
        while time.perf_counter() < t_end:
            buf += s.recv(1 << 20)
            while True:
                i = buf.find(b"Content-Length: ")
                j = buf.find(b"\r\n\r\n", i)
                if i < 0 or j < 0:
                    break
                n = int(buf[i + 16:j])
                if len(buf) < j + 4 + n:
                    break
                png_size(buf[j + 4:j + 4 + n])
                parts, last = parts + 1, n
                buf = buf[j + 4 + n:]
    finally:
        s.close()
    return parts, last


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ray_tracer_2_tpu_torch.assets.manager import AssetManager
    from ray_tracer_2_tpu_torch.config import RenderParams
    from ray_tracer_2_tpu_torch.engine.renderer import Renderer
    from ray_tracer_2_tpu_torch.kernels.brute import CUDA_BRUTE
    from ray_tracer_2_tpu_torch.kernels.cuda_build import build_all, \
        ptxas_lines
    from ray_tracer_2_tpu_torch.kernels.debug import CUDA_DEBUG
    from ray_tracer_2_tpu_torch.kernels.megakernel import (
        CUDA_MEGAKERNEL, brute_instances, kernel_tables, nee_mode,
        render_plain, samples_textures,
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
    kernels = (CUDA_MEGAKERNEL, CUDA_SPHERES, CUDA_BRUTE, CUDA_DEBUG)
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
    # sphere-heavy scenes through the megakernel: the dense fast loop, the
    # sphere BVH forced and by the scene's size, tables in global memory
    rballs_bvh = instantiate_scene(scenes.random_balls(),
                                   sphere_bvh=True).to("cuda")
    rballs_big = instantiate_scene(scenes.random_balls(half=24)).to("cuda")
    groups = instantiate_scene(scenes.groups_scene(5)).to("cuda")
    forms = {name: (kernel_tables(sc)["spheres_mode"],
                    kernel_tables(sc)["staged"])
             for name, sc in (("dense", rballs), ("bvh", rballs_bvh),
                              ("big", rballs_big), ("groups", groups))}
    check(forms == dict(dense=(1, True), bvh=(2, True), big=(2, True),
                        groups=(0, False)),
          f"sphere cells take their kernel forms: {forms}")
    aa = dict(antialias=True)
    balls_cmp = check_cases(
        [("random_balls + antialias", rballs, SMALL_W, SMALL_H, 0, aa),
         ("random_balls + antialias", rballs, SMALL_W, SMALL_H, BOUNCES, aa),
         ("random_balls + antialias, sphere BVH", rballs_bvh, SMALL_W,
          SMALL_H, 0, aa),
         ("random_balls + antialias, sphere BVH", rballs_bvh, SMALL_W,
          SMALL_H, BOUNCES, aa),
         (f"random_balls(half=24), {rballs_big.n_spheres} spheres",
          rballs_big, SMALL_W, SMALL_H, BOUNCES),
         ("groups_scene(5), tables in global memory", groups, SMALL_W,
          SMALL_H, BOUNCES),
         ("random_balls + antialias, sphere BVH", rballs_bvh, W, H, BOUNCES,
          aa),
         ("random_balls + antialias", rballs, W, H, BOUNCES, aa)],
        CUDA_MEGAKERNEL, render_plain, kernel="megakernel")
    bvh_cmp, dense_cmp = balls_cmp[-2:]
    check(bvh_cmp["rows_kernel"] >= bvh_cmp["segments_kernel"],
          "the sphere BVH's root row is evaluated in every segment")
    check(dense_cmp["rows_kernel"] == 0, "no tree in the dense sphere cell")
    room = instantiate_scene(scenes.room()).to("cuda")
    sph_cmp = check_cases(
        [("random_balls", rballs, SMALL_W, SMALL_H, 0),
         ("random_balls", rballs, SMALL_W, SMALL_H, BOUNCES),
         ("room", room, SMALL_W, SMALL_H, 0),
         ("room", room, SMALL_W, SMALL_H, BOUNCES),
         ("room", room, W, H, BOUNCES),
         ("random_balls", rballs, W, H, BOUNCES)],
        CUDA_SPHERES, render_spheres_plain, kernel="spheres")[-1]

    # ---- 3b. next-event estimation: the NEE forms against the plain version
    balls = instantiate_scene(scenes.balls()).to("cuda")
    sunlit_bvh = instantiate_scene(scenes.sunlit_balls(),
                                   sphere_bvh=True).to("cuda")
    modes = {name: nee_mode(sc, True) for name, sc in (
        ("room", room), ("balls", balls), ("room2", room2),
        ("sunlit_bvh", sunlit_bvh))}
    check(modes == dict(room=1, balls=1, room2=2, sunlit_bvh=2)
          and sunlit_bvh.sphere_bvh_root >= 0,
          f"NEE cells take their modes: {modes}")
    nee = dict(nee=True)
    forced = dict(nee=True, nee_segments=True)
    nee_cmp = check_cases(
        [("room", room, SMALL_W, SMALL_H, 0, nee),
         ("room", room, SMALL_W, SMALL_H, BOUNCES, nee),
         ("balls", balls, SMALL_W, SMALL_H, BOUNCES, nee),
         (small_name, room2_small, SMALL_W, SMALL_H, BOUNCES, nee),
         ("room, shadow segments forced", room, SMALL_W, SMALL_H, BOUNCES,
          forced),
         ("sunlit_balls, sphere BVH", sunlit_bvh, SMALL_W, SMALL_H, BOUNCES,
          nee),
         ("room2_scene", room2, W, H, BOUNCES, nee)],
        CUDA_MEGAKERNEL, render_plain, kernel="megakernel")
    kw = dict(width=SMALL_W, height=SMALL_H, bounces=BOUNCES,
              rays_per_pixel=1, skybox=True)
    inline, s_inline = CUDA_MEGAKERNEL(room, 1, nee=True, **kw)
    segmented, s_segmented = CUDA_MEGAKERNEL(room, 1, **forced, **kw)
    check(torch.equal(inline, segmented), "room: the kernel's mode 1 and "
                                          "forced mode 2 give one image")
    emit(phase="nee_modes_agree", scene="room", width=SMALL_W,
         height=SMALL_H, bounces=BOUNCES, segments_mode1=int(s_inline),
         segments_mode2=int(s_segmented),
         shadow_rays=nee_cmp[4]["shadow_rays_kernel"])
    check(int(s_segmented) - int(s_inline)
          == nee_cmp[4]["shadow_rays_kernel"],
          "forced mode 2 traces one segment more per shadow ray")

    # ---- 3c. textures and normal maps: the textured forms against the plain
    # version; the substitutes of sponza and bugatti
    def with_assets(build, **kw):
        assets = AssetManager()
        return instantiate_scene(build(assets), assets, **kw).to("cuda")

    def atrium64(every=1):
        return with_assets(lambda a: scenes.textured_atrium_scene(
            a, size=64, every=every))

    def spheres_tex(build, **kw):
        return with_assets(lambda a: scenes.textured_variant(build(), a,
                                                             every=7), **kw)

    atrium = atrium64()
    nmap = with_assets(scenes.normal_map_scene)
    nm_on = dict(normal_maps=True)
    tex_cases = [
        ("texture_sphere_scene", with_assets(scenes.texture_sphere_scene),
         SMALL_W, SMALL_H, b) for b in (0, 1, BOUNCES)] + [
        ("textured_atrium_scene(size=64)", atrium, SMALL_W, SMALL_H, 2),
        ("textured_atrium_scene(size=64)", atrium, SMALL_W, SMALL_H,
         BOUNCES),
        ("textured_atrium_scene(size=64, every=10)", atrium64(10), SMALL_W,
         SMALL_H, BOUNCES),
        ("normal_map_scene, normal maps off", nmap, SMALL_W, SMALL_H,
         BOUNCES),
        ("normal_map_scene, normal maps on", nmap, SMALL_W, SMALL_H, BOUNCES,
         nm_on),
        ("room, textured, NEE mode 1", with_assets(
            lambda a: scenes.textured_variant(scenes.room(), a, every=2)),
         SMALL_W, SMALL_H, BOUNCES, nee),
        ("textured_atrium_scene(size=64), NEE mode 2", atrium, SMALL_W,
         SMALL_H, BOUNCES, nee),
        ("random_balls, textured", spheres_tex(scenes.random_balls), SMALL_W,
         SMALL_H, BOUNCES),
        ("random_balls, textured, sphere BVH",
         spheres_tex(scenes.random_balls, sphere_bvh=True), SMALL_W, SMALL_H,
         BOUNCES),
        ("sunlit_balls, textured, NEE", spheres_tex(scenes.sunlit_balls),
         SMALL_W, SMALL_H, BOUNCES, nee),
        ("sunlit_balls, textured, sphere BVH, NEE",
         spheres_tex(scenes.sunlit_balls, sphere_bvh=True), SMALL_W, SMALL_H,
         BOUNCES, nee),
        ("bugatti", instantiate_scene(scenes.bugatti()).to("cuda"), SMALL_W,
         SMALL_H, BOUNCES),
        ("sponza", instantiate_scene(scenes.sponza()).to("cuda"), SMALL_W,
         SMALL_H, BOUNCES)]
    tex_forms, tex_cmp = set(), []
    for case in tex_cases:
        sc, opts = case[1], (case[5] if len(case) > 5 else {})
        tex_cmp += check_cases([case], CUDA_MEGAKERNEL, render_plain,
                               kernel="megakernel")
        textured = samples_textures(sc, opts.get("normal_maps", False))
        check(CUDA_MEGAKERNEL.tex_launches == (6 if textured else 0),
              f"{case[0]}: {CUDA_MEGAKERNEL.tex_launches} of 6 launches "
              f"through the textured forms (textured: {textured})")
        if textured:
            tex_forms.add((kernel_tables(sc)["spheres_mode"],
                           nee_mode(sc, opts.get("nee", False)) > 0))
    check(tex_forms == {(m, n) for m in range(3) for n in (False, True)},
          f"every textured form held against its plain version: {tex_forms}")
    kw = dict(width=SMALL_W, height=SMALL_H, bounces=BOUNCES,
              rays_per_pixel=1, skybox=True)
    nm_diff = float((CUDA_MEGAKERNEL(nmap, 1, **nm_on, **kw)[0]
                     - CUDA_MEGAKERNEL(nmap, 1, **kw)[0]).abs().max())
    check(nm_diff > 0.02, f"normal maps change the image ({nm_diff})")
    emit(phase="textured_forms", forms=sorted(tex_forms),
         normal_map_max_change=nm_diff)
    # the textured path's frame at 1080p, kernel against plain version
    t0 = time.perf_counter()
    tex_assets = AssetManager()
    atrium_1k = instantiate_scene(scenes.textured_atrium_scene(tex_assets),
                                  tex_assets).to("cuda")
    atrium_1k_s = time.perf_counter() - t0
    atlas_bytes = atrium_1k.tex_quads.numel() * 4
    check(atlas_bytes >= 10 * 1024 * 1024 * 16, f"atlas of {atlas_bytes} B")
    tex_big_cmp = check_cases(
        [("textured_atrium_scene(size=1024), NEE", atrium_1k, W, H, BOUNCES,
          nee)], CUDA_MEGAKERNEL, render_plain, kernel="megakernel")[0]

    # ---- 3d. the debug modes: csrc/debug.cu against its plain version in
    # every mode
    t0 = time.perf_counter()
    sponza = instantiate_scene(scenes.sponza()).to("cuda")
    sponza_s = time.perf_counter() - t0
    debug_main = compare_debug("main_path_scene", main_scene, W, H,
                               plain_mode=1)
    for name, sc, modes in (
            ("room", room, range(1, 8)),
            ("metal", instantiate_scene(scenes.metal()).to("cuda"),
             range(1, 8)),
            ("random_balls, sphere BVH", rballs_bvh, range(1, 8)),
            ("sponza()", sponza, range(1, 8)),
            ("normal_map_scene, TEXTURE flag", with_assets(
                lambda a: scenes.normal_map_scene(a, mapped_flag=True)),
             range(1, 2)),
            ("texture_sphere_scene", with_assets(
                scenes.texture_sphere_scene), range(3, 4))):
        r = compare_debug(name, sc, SMALL_W, SMALL_H, modes)
        check(r["hit_share"] is None or r["hit_share"] > 0.05,
              f"debug {name}: the scene fills part of the view")
    debug_b = debug_bound(main_scene, debug_main)

    # ---- 4. the main path -------------------------------------------------
    params = RenderParams(width=W, height=H, bounces=BOUNCES,
                          rays_per_pixel=1, skybox=True)
    def zero_counts():
        for k in kernels:
            k.reset_counts()

    zero_counts()
    dt, segs = drive(Renderer(device="cuda", mesh=None), main_scene, params)
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
    dt, segs = drive(Renderer(device="cuda", mesh=None), rballs, params)
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

    # ---- 5b. the sphere-scene path: Renderer -> megakernel, dense loop ----
    zero_counts()
    dt, segs = drive(Renderer(device="cuda", mesh=None), rballs,
                     dataclasses.replace(params, antialias=True))
    ball_launches = CUDA_MEGAKERNEL.launches
    check(ball_launches == FRAMES, f"megakernel launched {ball_launches} "
                                   f"times in {FRAMES} sphere-scene frames")
    check(CUDA_SPHERES.launches == 0, "no small-scene launch on the "
                                      "sphere-scene path")
    check(CUDA_MEGAKERNEL.prepass_counts() == (0, 0),
          "no brute-force prepass on the sphere-scene path")
    check(CUDA_MEGAKERNEL.read_counts()["rows"] == 0,
          "the sphere-scene path walks no tree")
    emit(phase="sphere_scene_path", scene="random_balls (485 spheres) with "
         "antialias", width=W, height=H, bounces=BOUNCES, rpp=1,
         frames=FRAMES, launches=ball_launches, segments=sum(segs),
         timed_frames="2-5", timed_segments=sum(segs[2:]),
         ms_per_frame=dt * 1e3 / (FRAMES - 2),
         mrays_per_s=sum(segs[2:]) / dt / 1e6, card=card)

    # ---- 6. the room2 path ------------------------------------------------
    zero_counts()
    dt, segs = drive(Renderer(device="cuda", mesh=None), room2, params)
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

    # ---- 6b. next-event estimation: Renderer -> the megakernel's NEE form
    zero_counts()
    dt, segs = drive(Renderer(device="cuda", mesh=None), room2,
                     dataclasses.replace(params, nee=True))
    nee_launches = CUDA_MEGAKERNEL.nee_launches
    counts = CUDA_MEGAKERNEL.read_counts()
    check(CUDA_MEGAKERNEL.launches == nee_launches == FRAMES,
          f"{nee_launches} NEE launches of {CUDA_MEGAKERNEL.launches} in "
          f"{FRAMES} NEE frames")
    check(CUDA_SPHERES.launches == CUDA_BRUTE.launches == 0,
          "no other kernel launched on the NEE path")
    check(counts["brute_calls"] == len(brute_instances(room2)) * sum(segs),
          "every segment, shadow segments included, ran the prepass")
    check(0 < counts["shadow_rays"] < sum(segs), "shadow segments traced")
    emit(phase="nee_path", scene="room2_scene with next-event estimation "
         "(shadow segments)", width=W, height=H, bounces=BOUNCES, rpp=1,
         frames=FRAMES, launches=CUDA_MEGAKERNEL.launches,
         nee_launches=nee_launches, segments=sum(segs),
         shadow_segments=counts["shadow_rays"],
         shadow_share=counts["shadow_rays"] / sum(segs),
         timed_frames="2-5", timed_segments=sum(segs[2:]),
         ms_per_frame=dt * 1e3 / (FRAMES - 2),
         mrays_per_s=sum(segs[2:]) / dt / 1e6, card=card)

    # ---- 6c. sponza: Renderer -> the megakernel on the atrium substitute,
    # without and with NEE; then the same geometry textured, with NEE
    check(sponza.inst_spans[0][2] == 41_424 and sponza.n_spheres == 1,
          f"sponza substitute: {sponza.inst_spans}, {sponza.n_spheres} "
          "spheres")
    # the untextured forms at the path's own shape, kernel against plain
    check_cases([("sponza()", sponza, W, H, BOUNCES),
                 ("sponza(), NEE mode 2", sponza, W, H, BOUNCES, nee)],
                CUDA_MEGAKERNEL, render_plain, kernel="megakernel")
    for flag in (False, True):
        zero_counts()
        dt, segs = drive(Renderer(device="cuda", mesh=None), sponza,
                         dataclasses.replace(params, nee=flag))
        counts = CUDA_MEGAKERNEL.read_counts()
        check(CUDA_MEGAKERNEL.launches == FRAMES
              and CUDA_MEGAKERNEL.nee_launches == (FRAMES if flag else 0)
              and CUDA_MEGAKERNEL.tex_launches == 0,
              f"sponza, nee={flag}: {CUDA_MEGAKERNEL.launches} launches, "
              f"{CUDA_MEGAKERNEL.nee_launches} NEE, "
              f"{CUDA_MEGAKERNEL.tex_launches} textured")
        check(CUDA_SPHERES.launches == CUDA_BRUTE.launches == 0,
              "no other kernel launched on the sponza path")
        check(counts["brute_calls"] == sum(segs), "every segment ran the "
              "light's brute-force group")
        emit(phase="sponza_path", scene="sponza() (procedural atrium, "
             "41,424 tris + quad light + emissive sphere)", nee=flag,
             width=W, height=H, bounces=BOUNCES, rpp=1, frames=FRAMES,
             scene_build_s=sponza_s, launches=CUDA_MEGAKERNEL.launches,
             nee_launches=CUDA_MEGAKERNEL.nee_launches, segments=sum(segs),
             segments_per_pixel=sum(segs) / (FRAMES * W * H),
             shadow_segments=counts["shadow_rays"],
             shadow_share=counts["shadow_rays"] / sum(segs),
             timed_frames="2-5", timed_segments=sum(segs[2:]),
             ms_per_frame=dt * 1e3 / (FRAMES - 2),
             mrays_per_s=sum(segs[2:]) / dt / 1e6, card=card)
    zero_counts()
    dt, segs = drive(Renderer(device="cuda", mesh=None), atrium_1k,
                     dataclasses.replace(params, nee=True))
    tex_launches = CUDA_MEGAKERNEL.tex_launches
    counts = CUDA_MEGAKERNEL.read_counts()
    check(CUDA_MEGAKERNEL.launches == CUDA_MEGAKERNEL.nee_launches
          == tex_launches == FRAMES,
          f"textured path: {tex_launches} textured launches of "
          f"{CUDA_MEGAKERNEL.launches} in {FRAMES} frames")
    check(CUDA_SPHERES.launches == CUDA_BRUTE.launches == 0,
          "no other kernel launched on the textured path")
    emit(phase="textured_path", scene="textured_atrium_scene(size=1024) "
         "with next-event estimation", width=W, height=H, bounces=BOUNCES,
         rpp=1, frames=FRAMES, scene_build_s=atrium_1k_s,
         atlas_bytes=atlas_bytes, atlas_mb=atlas_bytes / 1e6,
         texels=atlas_bytes // 16, launches=CUDA_MEGAKERNEL.launches,
         tex_launches=tex_launches, segments=sum(segs),
         segments_per_pixel=sum(segs) / (FRAMES * W * H),
         shadow_segments=counts["shadow_rays"],
         shadow_share=counts["shadow_rays"] / sum(segs),
         timed_frames="2-5", timed_segments=sum(segs[2:]),
         ms_per_frame=dt * 1e3 / (FRAMES - 2),
         mrays_per_s=sum(segs[2:]) / dt / 1e6, card=card)

    # ---- 6d. time to 1024 samples a pixel on room, NEE off and on
    spp = {}
    for flag in (False, True):
        zero_counts()
        p = dataclasses.replace(params, nee=flag)
        sec, mean = time_to_spp(Renderer(device="cuda", mesh=None), room, p)
        launched = (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.nee_launches)
        check(launched == ((0, SPP) if flag else (SPP, 0)),
              f"time to {SPP} spp, nee={flag}: launches {launched}")
        spp[flag] = dict(seconds=sec, mean=mean, variance=sample_variance(
            Renderer(device="cuda", mesh=None), room, p))
    check(abs(spp[True]["mean"] - spp[False]["mean"])
          <= 0.03 * spp[False]["mean"],
          f"NEE's mean {spp[True]['mean']} within 3% of plain path "
          f"tracing's {spp[False]['mean']}")
    emit(phase="time_to_spp", scene="room", spp=SPP, width=W, height=H,
         bounces=BOUNCES, seconds_plain=spp[False]["seconds"],
         seconds_nee=spp[True]["seconds"], mean_plain=spp[False]["mean"],
         mean_nee=spp[True]["mean"],
         variance_frames=SPP_VAR_FRAMES,
         variance_plain=spp[False]["variance"],
         variance_nee=spp[True]["variance"],
         variance_ratio=spp[False]["variance"] / spp[True]["variance"],
         card=card)

    # ---- 6e. the debug modes through Renderer.render: the debug kernel
    # only, one launch a frame
    from ray_tracer_2_tpu_torch.config import DebugMode
    zero_counts()
    renderer = Renderer(device="cuda", mesh=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for mode in range(1, 8):
        renderer.render(sponza, dataclasses.replace(
            params, debug_mode=DebugMode(mode), frames=0))
        check(int(renderer.last_segments) == 0, "a debug frame traces no "
                                                "path segments")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    debug_launches = CUDA_DEBUG.launches
    check(debug_launches == 7, f"debug kernel launched {debug_launches} "
                               "times in 7 debug frames")
    check(CUDA_MEGAKERNEL.launches == CUDA_SPHERES.launches
          == CUDA_BRUTE.launches == 0, "no other kernel on the debug path")
    check(bool(torch.isfinite(renderer.framebuffer).all()),
          "debug framebuffer finite")
    emit(phase="debug_path", scene="sponza() with debug modes 1-7",
         width=W, height=H, frames=7, launches=debug_launches,
         megakernel_launches=CUDA_MEGAKERNEL.launches,
         ms_per_frame=dt * 1e3 / 7, card=card)

    # ---- 6f. the Engine: async load, still frames, a camera move at half
    # resolution, still frames; the first still frame after the move
    # against a fresh scene at that pose
    from ray_tracer_2_tpu_torch.engine import Engine
    from ray_tracer_2_tpu_torch.scene.scenes import SceneName
    zero_counts()
    t0 = time.perf_counter()
    eng = Engine(W, H, initial_scene=SceneName.SPONZA, device="cuda",
                 mesh=None)
    while eng.update(dt=0.016) is None:
        check(time.perf_counter() - t0 < 120, "sponza loaded in the "
                                              "background")
        time.sleep(0.01)
    load_s = time.perf_counter() - t0
    host = eng.scene_manager.scene

    def still(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        segs = []
        for _ in range(n):
            eng.update(dt=0.016)
            segs.append(eng.renderer.last_segments)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        return sec, sum(int(x) for x in segs)

    sec, segs_8 = still(8)
    check(CUDA_MEGAKERNEL.launches == 9 and eng.params.frames == 8,
          f"engine: {CUDA_MEGAKERNEL.launches} megakernel launches, frame "
          f"{eng.params.frames} after 9 still frames")
    host.camera.controller.process_mouse(0.4, -0.1)
    host.camera.controller.process_keyboard("w", True)
    moving = eng.update(dt=0.05, sync=True)
    moving_stats = eng.stats    # a synchronous frame: its exact time
    host.camera.controller.process_keyboard("w", False)
    mp = eng._last_params
    check((mp.width, mp.height, mp.bounces) == (W // 2, H // 2, 1)
          and tuple(moving.shape) == (H // 2, W // 2, 4)
          and eng.params.frames == -1,
          f"engine: the moving frame at {mp.width}x{mp.height}, "
          f"{mp.bounces} bounce(s), counter {eng.params.frames}")
    first = eng.update(dt=0.016, sync=True).clone()
    fresh_def = scenes.sponza()
    fresh_def.camera.transform = host.camera.transform.copy()
    fresh = instantiate_scene(fresh_def).to("cuda")
    want = Renderer(device="cuda", mesh=None).render(
        fresh, dataclasses.replace(eng.params, frames=0))
    check(eng.params.frames == 0 and torch.equal(first, want),
          "engine: the first still frame after the move bit-equal to a "
          "fresh scene at the new pose")
    sec2, segs_after = still(4)
    stats = dataclasses.asdict(eng.stats)
    eng.scene_manager.shutdown()
    # 9 still frames, the moving one, the first still one after it, the
    # fresh scene's frame, 4 still frames
    check(CUDA_MEGAKERNEL.launches == 9 + 1 + 1 + 1 + 4
          and CUDA_DEBUG.launches == 0, "engine: every frame through the "
                                        "megakernel")
    emit(phase="engine_path", scene="Engine(1920, 1080, SPONZA)",
         width=W, height=H, bounces=BOUNCES, load_s=load_s,
         launches=CUDA_MEGAKERNEL.launches,
         still_ms_per_frame=sec * 1e3 / 8, still_mrays_per_s=segs_8 / sec / 1e6,
         after_move_ms_per_frame=sec2 * 1e3 / 4,
         after_move_mrays_per_s=segs_after / sec2 / 1e6,
         moving_frame=dict(width=mp.width, height=mp.height,
                           bounces=mp.bounces,
                           ms=moving_stats.frame_time_ms,
                           mrays_per_s=moving_stats.mrays_per_s),
         first_still_frame_equals_fresh_scene=True, frame_stats=stats,
         card=card)

    # ---- 6g. the CLI in a subprocess: straight, checkpointed and resumed,
    # batched; the three checkpoints' framebuffers bit-equal
    import tempfile
    from pathlib import Path

    import numpy as np
    root = Path(__file__).resolve().parent
    cli = ["--scene", "sponza", "--width", str(W), "--height", str(H),
           "--log-every", "16"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def ck(name):
            return ["--checkpoint", str(Path(tmp) / f"{name}.npz"), "-o",
                    str(Path(tmp) / f"{name}.png")]

        runs["straight"] = run_cli([*cli, "--spp", "16", *ck("straight")],
                                   root)
        runs["first_8"] = run_cli([*cli, "--spp", "8", *ck("resumed")],
                                  root)
        runs["resumed_to_16"] = run_cli(
            [*cli, "--spp", "16", "--resume", *ck("resumed")], root)
        check("resumed sponza at frame 8" in runs["resumed_to_16"][1],
              "cli: the second run resumed at frame 8")
        runs["batch_4"] = run_cli([*cli, "--spp", "16", "--batch", "4",
                                   *ck("batched")], root)
        fbs = {}
        for name in ("straight", "resumed", "batched"):
            with np.load(Path(tmp) / f"{name}.npz") as z:
                fbs[name] = z["framebuffer"]
            check((Path(tmp) / f"{name}.png").stat().st_size > 0,
                  f"cli: {name}.png written")
    check(fbs["straight"].shape == (H, W, 4)
          and np.isfinite(fbs["straight"]).all()
          and fbs["straight"].max() > 0, "cli: framebuffer finite, lit")
    check(fbs["straight"].tobytes() == fbs["resumed"].tobytes()
          == fbs["batched"].tobytes(), "cli: straight, resumed and batched "
                                       "framebuffers bit-equal")

    def s_per_frame(log):
        for ln in reversed(log.splitlines()):
            if "s/frame" in ln:
                return float(ln.split("s/frame")[0].split()[-1])
        return None

    emit(phase="cli_path", scene="sponza", spp=16, width=W, height=H,
         runs={k: dict(seconds=v[0], s_per_frame=s_per_frame(v[1]))
               for k, v in runs.items()},
         framebuffers_bit_equal=True, card=card)

    # ---- 6h. live edits: each edit's kernel frame against its plain
    # version at 128x72 (the tables built by a frame before the edit, so the
    # edit keeps them in step), then edits and next frames at 1080p
    from ray_tracer_2_tpu_torch.scene.render_scene import \
        instantiate_host_scene
    small_kw = dict(width=SMALL_W, height=SMALL_H, bounces=BOUNCES,
                    rays_per_pixel=1, skybox=True)
    edit_rows = []
    for name, host, opts, edit in edit_cases(scenes, instantiate_host_scene):
        small = name.startswith("metal")
        kernel = CUDA_SPHERES if small else CUDA_MEGAKERNEL
        plain = render_spheres_plain if small else render_plain
        before = host.scene
        kernel(host.scene, 1, **small_kw, **opts)      # tables built
        edit(host, 0)
        r = check_cases([(f"{name}, edited", host.scene, SMALL_W, SMALL_H,
                          BOUNCES, opts)], kernel, plain,
                        kernel="spheres" if small else "megakernel")[0]
        check(r["max_abs_err"] == 0.0, f"{name}: the edited scene's kernel "
                                       "frame bit-equal to its plain version")
        # 1080p: still frames, then ticks of edit + the next frame (the
        # viewer resets accumulation on an edit); the device idle before
        # each edit, so the edit's host time is its own
        renderer = Renderer(device="cuda", mesh=None)
        params_e = dataclasses.replace(params, **opts)
        ticks = 4 if "glass" in name else 8
        zero_counts()
        for f in range(3):
            renderer.render(host.scene, dataclasses.replace(params_e,
                                                            frames=f))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.render(host.scene, dataclasses.replace(params_e, frames=3))
        torch.cuda.synchronize()
        still_ms = (time.perf_counter() - t0) * 1e3
        edit_ms, next_ms, swaps = [], [], 0
        for k in range(1, ticks + 1):
            scene_before = host.scene
            t0 = time.perf_counter()
            edit(host, k)
            t1 = time.perf_counter()
            renderer.render(host.scene, dataclasses.replace(params_e,
                                                            frames=0))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            edit_ms.append((t1 - t0) * 1e3)
            next_ms.append((t2 - t1) * 1e3)
            swaps += host.scene is not scene_before
        frames_run = 4 + ticks
        launched = (kernel.launches, (CUDA_MEGAKERNEL if small
                                      else CUDA_SPHERES).launches,
                    CUDA_DEBUG.launches, CUDA_BRUTE.launches)
        check(launched == (frames_run, 0, 0, 0),
              f"{name}: launches {launched} for {frames_run} frames")
        check(bool(torch.isfinite(renderer.framebuffer).all()),
              f"{name}: framebuffer finite")
        row = dict(scene=name, kernel="spheres" if small else "megakernel",
                   width=W, height=H, bounces=BOUNCES, **opts,
                   ticks=ticks, launches=kernel.launches,
                   new_scene_objects=swaps + (host.scene is not before),
                   still_frame_ms=still_ms, edit_host_ms=edit_ms,
                   next_frame_ms=next_ms,
                   edit_host_ms_median=sorted(edit_ms)[ticks // 2],
                   next_frame_ms_median=sorted(next_ms)[ticks // 2],
                   max_abs_err_128x72=r["max_abs_err"],
                   nee_launches=CUDA_MEGAKERNEL.nee_launches, card=card)
        emit(phase="edit_path", **row)
        edit_rows.append(row)

    # ---- 6i. the viewer: ViewerServer on sponza() at 960x540 over
    # localhost; PNG frames from the card, one /ws input, one edit, the E
    # hotkey through the debug kernel
    import urllib.request
    from ray_tracer_2_tpu_torch.engine.export import framebuffer_to_srgb, \
        png_bytes
    from ray_tracer_2_tpu_torch.viewer.server import ViewerServer
    import threading
    VW, VH = 960, 540
    eng = Engine(VW, VH, initial_scene=SceneName.SPONZA,
                 block_on_initial_scene=True, device="cuda", mesh=None)
    vs = ViewerServer(eng, port=0)
    zero_counts()
    server = threading.Thread(target=vs.serve_forever)
    server.start()
    t0 = time.perf_counter()
    while vs._httpd is None or vs._frame_id < 3:
        check(time.perf_counter() - t0 < 120, "viewer: first frames")
        time.sleep(0.01)
    url = f"http://127.0.0.1:{vs._httpd.server_address[1]}"
    port = vs._httpd.server_address[1]
    state = json.loads(urllib.request.urlopen(url + "/state",
                                              timeout=30).read())
    check(state["scene"] == "Sponza", f"viewer state: {state['scene']}")
    frame = urllib.request.urlopen(url + "/frame.png", timeout=30).read()
    check(png_size(frame) == (VW, VH), "viewer: a 960x540 PNG frame")
    # the render loop's rate, and what a push-stream client receives
    f0, n0 = vs._frame_id, eng._frame_counter
    t0 = time.perf_counter()
    parts, part_bytes = stream_frames(port, 4.0)
    window = time.perf_counter() - t0
    produced = vs._frame_id - f0
    rendered = eng._frame_counter - n0
    check(parts > 0, "viewer: PNG frames pushed to the stream client")
    # what one of these frames costs the loop on the host: the readback,
    # gamma in numpy, the PNG (zlib level 6) of a frame at this noise
    loop_encode_ms = vs.encode_ms
    fb, read_ms = timed(lambda: eng.renderer.read_framebuffer())
    rgb, srgb_ms = timed(lambda: framebuffer_to_srgb(fb))
    enc = []
    for _ in range(3):
        t1 = time.perf_counter()
        data = png_bytes(rgb)
        enc.append((time.perf_counter() - t1) * 1e3)
    # one /ws input and one edit_entity over POST /input
    pongs = ws_exchange(port, [{"set": {"bounces": 4}}])
    check(pongs == [{"pong": 0}] and eng.params.bounces == 4,
          f"viewer: /ws input handled ({pongs}, {eng.params.bounces})")
    host_v = eng.scene_manager.scene
    req = urllib.request.Request(url + "/input", method="POST", data=json.
                                 dumps({"edit_entity": {
                                     "kind": "sphere", "index": 0,
                                     "centre": [5.0, 2.5, 0.0]}}).encode())
    check(urllib.request.urlopen(req, timeout=30).status == 200,
          "viewer: edit_entity accepted")
    check(host_v.scene.sphere_pos[0].cpu().tolist() == [5.0, 2.5, 0.0],
          "viewer: the edit reached the scene on the card")
    f_edit = vs._frame_id
    while vs._frame_id < f_edit + 3:
        check(time.perf_counter() - t0 < 120, "viewer: frames after edit")
        time.sleep(0.01)
    # E: the debug modes through csrc/debug.cu, then back to the lit path
    ws_exchange(port, [{"keys": {"e": True}}, {"keys": {"e": False}}])
    f_dbg = vs._frame_id
    while vs._frame_id < f_dbg + 3:
        check(time.perf_counter() - t0 < 120, "viewer: debug frames")
        time.sleep(0.01)
    ws_exchange(port, [{"set": {"debug_mode": 0}}])
    vs.shutdown()
    server.join(timeout=60)
    check(not server.is_alive() and not vs._render_thread.is_alive(),
          "viewer: server and render loop stopped")
    total_frames = eng._frame_counter     # every frame since zero_counts
    viewer_launches = dict(megakernel=CUDA_MEGAKERNEL.launches,
                           debug=CUDA_DEBUG.launches,
                           spheres=CUDA_SPHERES.launches,
                           brute=CUDA_BRUTE.launches)
    check(viewer_launches["debug"] > 0 and viewer_launches["megakernel"] > 0
          and viewer_launches["spheres"] == viewer_launches["brute"] == 0,
          f"viewer: frames through the megakernel and, after E, the debug "
          f"kernel: {viewer_launches}")
    check(viewer_launches["megakernel"] + viewer_launches["debug"]
          == total_frames, f"viewer: {total_frames} frames, launches "
                           f"{viewer_launches}")
    # Engine's own frame time on the same scene and size
    eng.params = dataclasses.replace(eng.params, frames=0)
    for _ in range(2):
        eng.update(dt=0.016)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(8):
        eng.update(dt=0.016)
    torch.cuda.synchronize()
    engine_ms = (time.perf_counter() - t1) * 1e3 / 8
    eng.scene_manager.shutdown()
    emit(phase="viewer_path", scene="ViewerServer(Engine(960, 540, SPONZA))",
         width=VW, height=VH, bounces=BOUNCES, window_s=window,
         frames_rendered_in_window=rendered,
         frames_encoded_in_window=produced,
         frames_per_s=produced / window,
         stream_frames_delivered=parts, delivered_per_s=parts / window,
         png_bytes=len(data), stream_part_bytes=part_bytes,
         encode_ms=sorted(enc)[1], encode_ms_runs=enc,
         to_srgb_ms=srgb_ms, readback_ms=read_ms,
         loop_encode_ms=loop_encode_ms, engine_ms_per_frame=engine_ms,
         host_ms_per_frame=read_ms + srgb_ms + sorted(enc)[1],
         launches=viewer_launches, frames=total_frames,
         ws_input=True, edit_entity=True, card=card)

    # ---- 6j. the multi-card layouts over meshes that repeat the card
    sharded = sharded_path(card, main_scene, room2_small, dict(
        megakernel=CUDA_MEGAKERNEL, spheres=CUDA_SPHERES, debug=CUDA_DEBUG,
        brute=CUDA_BRUTE), zero_counts)
    emit(phase="sharded_path", **sharded)

    # ---- 6k. the twin of __graft_entry__.py on the card: one progressive
    # step (bit-equal to Renderer's frame), then the multi-card dry run over
    # a mesh that names the card four times
    from ray_tracer_2_tpu_torch import graft_entry
    zero_counts()
    fn, (g_scene, g_fb, g_frames, g_scale) = graft_entry.entry("cuda")
    step = fn(g_scene, g_fb, g_frames, g_scale)
    want = Renderer(device="cuda", mesh=None).render(g_scene, RenderParams(
        width=graft_entry.W, height=graft_entry.H, bounces=3,
        frames=g_frames))
    check(torch.equal(step, want), "graft entry: the step bit-equal to "
                                   "Renderer's frame")
    runs = graft_entry.dryrun_multichip(4, device="cuda")
    emit(phase="graft_entry", entry_shape=list(step.shape),
         dryrun={k: dict(shape=list(v[0].shape), segments=v[1])
                 for k, v in runs.items()},
         launches=dict(megakernel=CUDA_MEGAKERNEL.launches,
                       spheres=CUDA_SPHERES.launches), card=card)

    # ---- 7. the probes ------------------------------------------------------
    zero_counts()
    for w in probe_wrappers:
        w.reset_counts()
    t0 = time.perf_counter()
    ctx = probes.Ctx(device=torch.device("cuda", 0), seed=0, smoke=True,
                     card=card)
    check(probes.run(ctx, probes.kernel_probes()), "every probe ran and "
          "matched its plain version (mxu_leaf_dense on the tensor cores: "
          "passed its gate)")
    check(sum(r["probe"] == "mxu_leaf_dense" for r in ctx.records) == 6,
          "mxu_leaf_dense: three forms at two sizes")
    probe_launches = {name: w.launches for name, (w, _) in
                      probes.KERNELS.items()}
    probe_launches["trav_sched"] = TRAV_SCHED.launches
    for name, n in probe_launches.items():
        check(n > 0, f"probe kernel {name} launched")
    for r in ctx.records:
        if r["gate"] is not None:   # the tensor-core form: its stated gate
            check(r["gate"]["ok"] is True, f"probe {r['probe']} "
                  f"{r.get('form')} inside its gate")
        else:
            check(r["plain_equal"] is True, f"probe {r['probe']} bit-equal "
                                            "to its plain version")
    emit(phase="probes", probes=len(ctx.records),
         seconds=time.perf_counter() - t0, launches=probe_launches,
         card=card)
    check(CUDA_MEGAKERNEL.launches == CUDA_SPHERES.launches
          == CUDA_DEBUG.launches == 0, "no render kernel launched by the "
                                       "probes")

    # bounds from this run's counted work on the timed 1080p cells; no one
    # PyTorch call computes a path-traced frame or a closest hit over a
    # triangle table, so library_ms is null
    main_b = megakernel_bound(main_scene, main_cmp)
    room2_b = megakernel_bound(room2, room2_cmp)
    nee_b = megakernel_bound(room2, nee_cmp[-1], nee_mode=2)
    room_nee_b = megakernel_bound(room, nee_cmp[1], nee_mode=1)
    tex_b = megakernel_bound(atrium_1k, tex_big_cmp, nee_mode=2,
                             taps=tex_big_cmp["texture_taps_plain"])

    def sphere_cell(scene, r, **more):
        return dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                    max_abs_err=r["max_abs_err"],
                    lane_occupancy=r["lane_occupancy"],
                    segments=r["segments_kernel"],
                    mrays_per_s=r["segments_kernel"] / r["kernel_ms"] / 1e3,
                    rows_per_segment=r["rows_kernel"] / r["segments_kernel"],
                    leaves_per_segment=r["leaves_kernel"]
                    / r["segments_kernel"],
                    boxes_per_segment=r["boxes_kernel"]
                    / r["segments_kernel"],
                    **megakernel_bound(scene, r), **more)
    sph_b = spheres_bound(rballs, sph_cmp)
    emit(kernels=[
        dict(name="megakernel", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/megakernel.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_boundary.py:236",
             launches=launches, launches_per_frame=launches / FRAMES,
             max_abs_err=main_cmp["max_abs_err"],
             ms=main_cmp["kernel_ms"], plain_ms=main_cmp["plain_ms"],
             bound_ms=main_b["bound_ms"], bound_by=main_b["bound_by"],
             bound_nofma_ms=main_b["bound_nofma_ms"],
             library_ms=None, ops=main_b["ops"], bytes=main_b["bytes"],
             lane_occupancy=main_cmp["lane_occupancy"],
             room2=dict(launches_per_frame=room2_launches / FRAMES,
                        ms=room2_cmp["kernel_ms"],
                        plain_ms=room2_cmp["plain_ms"],
                        max_abs_err=room2_cmp["max_abs_err"],
                        lane_occupancy=room2_cmp["lane_occupancy"],
                        **room2_b),
             random_balls_dense=sphere_cell(
                 rballs, dense_cmp,
                 launches_per_frame=ball_launches / FRAMES),
             random_balls_sphere_bvh=sphere_cell(rballs_bvh, bvh_cmp)),
        # next-event estimation: the NEE forms of megakernel.cu; in the
        # reference it runs in the XLA boundary (megakernel.py:888-1082),
        # beside the TPU kernel the megakernel replaces
        dict(name="megakernel_nee", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/megakernel.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_boundary.py:236",
             reference="ray_tracer_2_tpu/kernels/megakernel.py:888",
             launches=nee_launches, launches_per_frame=nee_launches / FRAMES,
             max_abs_err=nee_cmp[-1]["max_abs_err"],
             ms=nee_cmp[-1]["kernel_ms"], plain_ms=nee_cmp[-1]["plain_ms"],
             bound_ms=nee_b["bound_ms"], bound_by=nee_b["bound_by"],
             bound_nofma_ms=nee_b["bound_nofma_ms"], library_ms=None,
             ops=nee_b["ops"], bytes=nee_b["bytes"],
             lane_occupancy=nee_cmp[-1]["lane_occupancy"],
             segments=nee_cmp[-1]["segments_kernel"],
             shadow_rays=nee_cmp[-1]["shadow_rays_kernel"],
             room_inline_128x72=dict(
                 ms=nee_cmp[1]["kernel_ms"], plain_ms=nee_cmp[1]["plain_ms"],
                 max_abs_err=nee_cmp[1]["max_abs_err"],
                 shadow_rays=nee_cmp[1]["shadow_rays_kernel"],
                 **room_nee_b)),
        # textures and normal maps: the textured forms of megakernel.cu; in
        # the reference they run in the XLA boundary (megakernel.py:796-884),
        # beside the TPU kernel the megakernel replaces, which refuses them
        dict(name="megakernel_tex", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/megakernel.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_boundary.py:236",
             reference="ray_tracer_2_tpu/kernels/megakernel.py:796",
             launches=tex_launches, launches_per_frame=tex_launches / FRAMES,
             max_abs_err=tex_big_cmp["max_abs_err"],
             ms=tex_big_cmp["kernel_ms"], plain_ms=tex_big_cmp["plain_ms"],
             bound_ms=tex_b["bound_ms"], bound_by=tex_b["bound_by"],
             bound_nofma_ms=tex_b["bound_nofma_ms"], library_ms=None,
             ops=tex_b["ops"], bytes=tex_b["bytes"],
             lane_occupancy=tex_big_cmp["lane_occupancy"],
             segments=tex_big_cmp["segments_kernel"],
             shadow_rays=tex_big_cmp["shadow_rays_kernel"],
             texture_taps=tex_big_cmp["texture_taps_plain"],
             atlas_bytes=atlas_bytes, forms=len(tex_forms),
             max_abs_err_128x72=max(r["max_abs_err"] for r in tex_cmp)),
        dict(name="spheres", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/spheres.cu",
             replaces="ray_tracer_2_tpu/kernels/pallas_spheres.py:149",
             launches=sph_launches, launches_per_frame=sph_launches / FRAMES,
             max_abs_err=sph_cmp["max_abs_err"],
             ms=sph_cmp["kernel_ms"], plain_ms=sph_cmp["plain_ms"],
             bound_ms=sph_b["bound_ms"], bound_by=sph_b["bound_by"],
             bound_nofma_ms=sph_b["bound_nofma_ms"],
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
             bound_nofma_ms=brute_cmp["bound_nofma_ms"],
             library_ms=None, ops=brute_cmp["ops"],
             bytes=brute_cmp["bytes"],
             rays_per_thread=brute_cmp["rays_per_thread"],
             ptxas=brute_cmp["ptxas"]),
        # the debug modes: a kernel of its own, where the reference computes
        # in XLA apart from its brute-force groups (pallas_brute, whose
        # loop runs here inside the kernel)
        dict(name="debug", route="cuda",
             source="ray_tracer_2_tpu_torch/csrc/debug.cu",
             replaces="ray_tracer_2_tpu/kernels/trace.py:384",
             reference="ray_tracer_2_tpu/kernels/trace.py:384",
             tpu_kernel_on_path="ray_tracer_2_tpu/kernels/pallas_brute.py:32",
             launches=debug_launches, launches_per_frame=debug_launches / 7,
             max_abs_err=debug_main["max_abs_err"],
             ms=debug_main["kernel_ms"], plain_ms=debug_main["plain_ms"],
             bound_ms=debug_b["bound_ms"], bound_by=debug_b["bound_by"],
             bound_nofma_ms=debug_b["bound_nofma_ms"], library_ms=None,
             ops=debug_b["ops"], bytes=debug_b["bytes"],
             cell="main_path_scene 1920x1080, mode 1",
             boxes=debug_main["boxes"], triangle_tests=debug_main["tris"]),
        *[probe_entry(name, w, replaces, probe_launches, ctx.records)
          for name, (w, replaces) in probes.KERNELS.items()]])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
