"""Entry points of the port: one progressive step, and a dry run of every
multi-card layout (the port's twin of the repository's root
``__graft_entry__.py``, which drives the JAX package).

``entry()`` gives one progressive render step and its arguments: camera
rays, the BVH walk, shading and the accumulation blend on ``scenes.room()``
at 128x72, 3 bounces. ``dryrun_multichip(n)`` renders each frame of the
reference's multi-chip dry run over a mesh of ``n`` devices
(``parallel/sharding.py``): row tiles, a sample round, row tiles of the
wide-BVH scene, the 2-D rows x spp mesh, and row tiles with next-event
estimation and antialias. The reference forces ``n`` virtual CPU devices;
here the mesh takes ``n`` distinct cards where the host has them, and
otherwise names ``device`` ``n`` times, so that one card (or the CPU) runs
every layout. The TPU scheduling knobs of the reference's dry run
(``lanes``, ``unroll``, ``log_cap``, ``fused_boundary``) have no
counterpart in the port.
"""
from __future__ import annotations

import torch

W, H = 128, 72


def _flagship_scene(device):
    """``scenes.room()``: procedural meshes (brute-force groups), glass,
    mirror and emissive materials, no asset file."""
    from ray_tracer_2_tpu_torch.scene import scenes
    from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
    return instantiate_scene(scenes.room()).to(device)


def _wide_bvh_scene(device):
    """The asset-free 1,496-triangle lat/lon sphere that engages the wide
    BVH walk (``scenes.wide_bvh_scene``)."""
    from ray_tracer_2_tpu_torch.scene import scenes
    from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
    scene = instantiate_scene(scenes.wide_bvh_scene()).to(device)
    assert any(r >= 0 for r in scene.wide_roots)
    return scene


def entry(device="cuda"):
    """Returns (fn, args): ``fn(scene, framebuffer, frames, debug_scale)``
    renders one sample at 128x72, 3 bounces, and returns the framebuffer
    blended with it at ``1 / (frames + 1)`` (a new tensor)."""
    from ray_tracer_2_tpu_torch.engine.renderer import (
        blend, blend_weight, render_sample,
    )

    def forward(scene, framebuffer, frames, debug_scale):
        sample, _segs = render_sample(
            scene, frames, width=W, height=H, bounces=3, rays_per_pixel=1,
            skybox=True, debug_mode=0, debug_scale=debug_scale)
        out = framebuffer.clone()
        blend(out, sample, blend_weight(frames))
        return out

    fb = torch.zeros((H, W, 4), dtype=torch.float32, device=device)
    return forward, (_flagship_scene(device), fb, 1, 100.0)


def _mesh_devices(n_devices: int, device) -> list:
    """``n_devices`` distinct cards where ``device`` is an unnumbered CUDA
    device and the host has that many; else ``device``, ``n_devices``
    times."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [dev] * n_devices


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Render every frame of the reference's multi-chip dry run over a mesh
    of ``n_devices`` devices (``_mesh_devices``) at 64 columns and 8 rows a
    device, 2 bounces. Returns {name: (framebuffer on the host, segments)};
    raises if a frame fails or is not finite."""
    from ray_tracer_2_tpu_torch.parallel.sharding import (
        make_render_mesh, make_render_mesh2d, render_frame_hybrid_sharded,
        render_frame_sharded, render_frame_spp_sharded, replicate_scene,
        shard_framebuffer,
    )

    devices = _mesh_devices(n_devices, device)
    mesh = make_render_mesh(n_devices, devices)
    w, h = 64, 8 * n_devices     # one 8-row tile a device
    kw = dict(width=w, height=h, bounces=2, rays_per_pixel=1, skybox=True)
    flagship = replicate_scene(_flagship_scene(mesh.home), mesh)
    out = {}

    def rows(name, scene, **more):
        fb = shard_framebuffer(torch.zeros((h, w, 4), dtype=torch.float32,
                                           device=mesh.home), mesh)
        out[name] = render_frame_sharded(scene, fb, 1, 100.0, mesh=mesh,
                                         **kw, **more)

    rows("rows", flagship)
    fb = torch.zeros((8, w, 4), dtype=torch.float32, device=mesh.home)
    out["spp"] = render_frame_spp_sharded(flagship, fb, 0, mesh=mesh,
                                          **dict(kw, height=8))
    rows("wide_bvh", replicate_scene(_wide_bvh_scene(mesh.home), mesh))
    if n_devices >= 2:
        r = n_devices // 2
        mesh2 = make_render_mesh2d(r, 2, devices)
        fb = shard_framebuffer(torch.zeros((8 * r, w, 4),
                                           dtype=torch.float32,
                                           device=mesh.home), mesh2)
        out["hybrid"] = render_frame_hybrid_sharded(
            replicate_scene(_flagship_scene(mesh.home), mesh2), fb, 1,
            mesh=mesh2, **dict(kw, height=8 * r))
    rows("nee_antialias", flagship, nee=True, antialias=True)
    result = {}
    for name, (fb, segs) in out.items():
        img = fb.cpu()
        if not bool(torch.isfinite(img).all()) or int(segs) <= 0:
            raise RuntimeError(f"dry run {name}: not finite or no segments")
        result[name] = (img.numpy(), int(segs))
    return result
