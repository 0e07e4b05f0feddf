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


def time_to_spp(scene, params):
    """SPP progressive frames of one sample a pixel through
    ``Renderer.render``; returns (seconds from the first frame to the last
    one's end, mean of the final image's rgb over all pixels)."""
    from ray_tracer_2_tpu_torch.engine.renderer import Renderer
    renderer = Renderer(device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in range(SPP):
        renderer.render(scene, dataclasses.replace(params, frames=f))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    fb = renderer.framebuffer
    check(bool(torch.isfinite(fb).all()), "converged image finite")
    return sec, float(fb[..., :3].double().mean())


def sample_variance(scene, params) -> float:
    """Per-sample variance of the rgb of each pixel, averaged over the
    image, from the SPP_VAR_FRAMES first frames of ``Renderer.render``: each
    frame's own sample is read off the accumulation (frame f's buffer times
    f + 1 less frame f - 1's times f, in float64)."""
    from ray_tracer_2_tpu_torch.engine.renderer import Renderer
    renderer = Renderer(device="cuda")
    s1 = s2 = prev = None
    for f in range(SPP_VAR_FRAMES):
        fb = renderer.render(scene, dataclasses.replace(params, frames=f))
        fb = fb[..., :3].double()
        raw = fb if f == 0 else fb * (f + 1) - prev * f
        s1 = raw if s1 is None else s1 + raw
        s2 = raw * raw if s2 is None else s2 + raw * raw
        prev = fb.clone()
    n = SPP_VAR_FRAMES
    return float(((s2 - s1 * s1 / n) / (n - 1)).mean())


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
    from ray_tracer_2_tpu_torch.assets.manager import AssetManager
    from ray_tracer_2_tpu_torch.config import RenderParams
    from ray_tracer_2_tpu_torch.engine.renderer import Renderer
    from ray_tracer_2_tpu_torch.kernels.brute import CUDA_BRUTE
    from ray_tracer_2_tpu_torch.kernels.cuda_build import build_all, \
        ptxas_lines
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

    # ---- 5b. the sphere-scene path: Renderer -> megakernel, dense loop ----
    zero_counts()
    dt, segs = drive(Renderer(device="cuda"), rballs,
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

    # ---- 6b. next-event estimation: Renderer -> the megakernel's NEE form
    zero_counts()
    dt, segs = drive(Renderer(device="cuda"), room2,
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
    t0 = time.perf_counter()
    sponza = instantiate_scene(scenes.sponza()).to("cuda")
    sponza_s = time.perf_counter() - t0
    check(sponza.inst_spans[0][2] == 41_424 and sponza.n_spheres == 1,
          f"sponza substitute: {sponza.inst_spans}, {sponza.n_spheres} "
          "spheres")
    # the untextured forms at the path's own shape, kernel against plain
    check_cases([("sponza()", sponza, W, H, BOUNCES),
                 ("sponza(), NEE mode 2", sponza, W, H, BOUNCES, nee)],
                CUDA_MEGAKERNEL, render_plain, kernel="megakernel")
    for flag in (False, True):
        zero_counts()
        dt, segs = drive(Renderer(device="cuda"), sponza,
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
    dt, segs = drive(Renderer(device="cuda"), atrium_1k,
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
        sec, mean = time_to_spp(room, dataclasses.replace(params, nee=flag))
        launched = (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.nee_launches)
        check(launched == ((0, SPP) if flag else (SPP, 0)),
              f"time to {SPP} spp, nee={flag}: launches {launched}")
        spp[flag] = dict(seconds=sec, mean=mean, variance=sample_variance(
            room, dataclasses.replace(params, nee=flag)))
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
    check(CUDA_MEGAKERNEL.launches == CUDA_SPHERES.launches == 0,
          "no render kernel launched by the probes")

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
        *[probe_entry(name, w, replaces, probe_launches, ctx.records)
          for name, (w, replaces) in probes.KERNELS.items()]])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
