"""How each cell's frozen work (``cells/<cell>.json`` ``work``) was worked
out, once, on the card, from the program's device counters::

    python3 -m rtbench.calibrate <cell> [<cell> ...]

For each cell it drives the cell's frames through ``Engine.update`` with
the megakernel's counters reset, reads the child boxes and leaves it
visited and the exact segments it traced, counts the texel quads one frame
fetches with the program's plain version (the kernel does not count taps),
and prints ``ops_per_segment`` (``frozen.work.per_segment_work``) and
``bytes_per_frame`` (the tables read once, the image written once, the
taps' quads). The result is copied into the cell's file by hand; a run
never calls this, so a faster traversal does not move the yardstick.
"""
from __future__ import annotations

import json
import sys

from rtbench import manifest, traffic
from rtbench.frozen.work import TAP_BYTES, per_segment_work

FRAMES = 8


def calibrate(name: str, device: str = "cuda") -> dict:
    import torch
    from rtbench import program
    from ray_tracer_2_tpu_torch.kernels import megakernel as mk

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
    k = mk.CUDA_MEGAKERNEL
    k.reset_counts()
    segs = sum(int(frame()) for _ in range(FRAMES))
    eng.renderer.synchronize()
    c = k.read_counts()
    scene = eng.scene_manager.scene.scene
    p = eng._last_params
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
    tables = sum(t.numel() * t.element_size()
                 for t in (scene.wide_rows, scene.tri_attr, scene.mat_rows))
    seg_frame = segs / FRAMES
    out = dict(cell=name, frames=FRAMES, segments=segs, counts=c,
               taps_per_segment=taps, ops_per_segment=ops,
               bytes_per_frame=tables + p.width * p.height * 16
               + taps * seg_frame * TAP_BYTES,
               card=torch.cuda.get_device_name(0))
    eng.scene_manager.shutdown()
    return out


if __name__ == "__main__":
    for n in sys.argv[1:]:
        print(json.dumps(calibrate(n)), flush=True)
