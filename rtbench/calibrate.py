"""How each cell's frozen work (``cells/<cell>.json`` ``work``) was worked
out, once, on the card, from the program's device counters::

    python3 -m rtbench.calibrate <cell> [<cell> ...]

For each cell it drives the cell's frames through ``Engine.update`` with
the render kernels' counters reset, finds which kernel the frames took by
whose launch count moved, and prints ``ops_per_segment`` and
``bytes_per_frame`` by that kernel's rule:

* the megakernel: the child boxes and leaves it visited over the exact
  segments it traced, and the texel quads one frame fetches, counted with
  the program's plain version (the kernel does not count taps)
  (``frozen.work.per_segment_work``); the tables read once, the image
  written once, the taps' quads;
* the small-scene kernel (``csrc/spheres.cu``): every sphere and triangle
  tested each segment (``frozen.work.small_scene_work``); its tables
  (spheres, triangles, fields) read once, the image written once.

The result is copied into the cell's file by hand; a run never calls
this, so a faster traversal does not move the yardstick.
"""
from __future__ import annotations

import json
import sys

from rtbench import manifest, traffic
from rtbench.frozen.work import TAP_BYTES, per_segment_work, \
    small_scene_work

FRAMES = 8


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _megakernel_work(scene, p, segs: int, c: dict) -> dict:
    from ray_tracer_2_tpu_torch.kernels import megakernel as mk

    taps = 0
    if mk.samples_textures(scene):
        counts = {}
        _, plain_segs = mk.render_plain(
            scene, p.frames, width=p.width, height=p.height,
            bounces=p.bounces, rays_per_pixel=1, skybox=p.skybox,
            counts=counts)
        taps = counts.get("texture_taps", 0) / int(plain_segs)
    brute = mk.brute_instances(scene)
    ops = per_segment_work(
        segments=segs, boxes=c["boxes"], leaves=c["leaves"],
        dense_spheres=mk.dense_spheres(scene),
        brute_tris=sum(scene.inst_spans[i][2] for i in brute),
        brute_instances=len(brute),
        bvh_instances=len(mk.bvh_instances(scene)),
        taps=round(taps * segs))
    tables = _nbytes(scene.wide_rows, scene.tri_attr, scene.mat_rows)
    return dict(taps_per_segment=taps, ops_per_segment=ops,
                bytes_per_frame=tables + p.width * p.height * 16
                + taps * (segs / FRAMES) * TAP_BYTES)


def _small_scene_work(scene, p) -> dict:
    from ray_tracer_2_tpu_torch.kernels import spheres as sk

    tab = sk.pack_tables(scene)
    return dict(ops_per_segment=small_scene_work(tab.n_spheres, tab.n_tris),
                bytes_per_frame=_nbytes(tab.spheres, tab.tris, tab.fields)
                + p.width * p.height * 16)


def calibrate(name: str, device: str = "cuda") -> dict:
    import torch
    from rtbench import program
    from ray_tracer_2_tpu_torch.kernels import megakernel as mk
    from ray_tracer_2_tpu_torch.kernels import spheres as sk

    man = manifest.load()
    cell = manifest.cell(man, name)
    spec = manifest.config(man, cell["config"])
    mix = traffic.load(cell["traffic"])
    inputs = manifest.builder(cell["config"]).inputs(spec, 0)
    eng = program.engine(inputs, device, traffic.params(mix))
    frames = traffic.Frames(mix, 0, eng)

    def frame():
        frames.step()
        return eng.renderer.last_segments

    for _ in range(2):
        frame()
    eng.renderer.synchronize()
    kernels = dict(megakernel=mk.CUDA_MEGAKERNEL, spheres=sk.CUDA_SPHERES)
    for k in kernels.values():
        k.reset_counts()
    segs = sum(int(frame()) for _ in range(FRAMES))
    eng.renderer.synchronize()
    took = [n for n, k in kernels.items() if k.launches]
    if len(took) != 1:
        raise RuntimeError(f"{name}: the frames launched {took or 'no'} "
                           "render kernels; one was expected")
    c = kernels[took[0]].read_counts()
    scene = eng.scene_manager.scene.scene
    p = eng._last_params
    out = dict(cell=name, frames=FRAMES, segments=segs, counts=c)
    out.update(_small_scene_work(scene, p) if took[0] == "spheres"
               else _megakernel_work(scene, p, segs, c))
    out["card"] = torch.cuda.get_device_name(0)
    eng.scene_manager.shutdown()
    return out


if __name__ == "__main__":
    for n in sys.argv[1:]:
        print(json.dumps(calibrate(n)), flush=True)
