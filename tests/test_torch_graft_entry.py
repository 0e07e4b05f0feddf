"""The port's twin of ``__graft_entry__.py``
(``ray_tracer_2_tpu_torch/graft_entry.py``), on the CPU.

``entry()``: one progressive step at 128x72, 3 bounces, on ``room``; its
frame is the port's ``render_frame`` of the same frame (bit-equal: one
sample blended at ``1/(frames+1)``) and agrees with the reference's
``entry()`` (run under ``jax.jit``; it returns no segment count) in the
chaos class (c): at least 99% of pixels within 1e-5.

``dryrun_multichip(n, device="cpu")``: every frame of the reference's dry
run over a mesh naming the CPU n times (rows, a sample round, the
wide-BVH scene, the 2-D mesh, NEE with antialias), each finite, with
segments, and the row-tiled frames within ``ULP_TOL`` of the same frames
on one device (segments exact): on the CPU a row window moves a pixel's
place in a batch, which rounds an ulp differently (see
``tests/test_torch_sharding.py``).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tracer_2_tpu_torch import graft_entry
from ray_tracer_2_tpu_torch.engine.renderer import render_frame
from torch_bridge import frac_within
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

ULP_TOL = 1e-6


def _ref_entry():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import __graft_entry__
    return __graft_entry__.entry()


def test_entry_step():
    fn, (scene, fb, frames, scale) = graft_entry.entry("cpu")
    assert tuple(fb.shape) == (72, 128, 4) and scene.device.type == "cpu"
    out = fn(scene, fb, frames, scale)
    want, segs = render_frame(scene, torch.zeros_like(fb), frames,
                              width=128, height=72, bounces=3,
                              rays_per_pixel=1, skybox=True)
    assert torch.equal(out, want)
    assert torch.count_nonzero(fb) == 0          # a new tensor
    ref_fn, ref_args = _ref_entry()
    ref_out = np.asarray(jax.jit(ref_fn)(*ref_args))
    assert frac_within(out.numpy(), ref_out, 1e-5) >= 0.99


def test_dryrun_multichip():
    n = 4
    runs = graft_entry.dryrun_multichip(n, device="cpu")
    assert set(runs) == {"rows", "spp", "wide_bvh", "hybrid",
                         "nee_antialias"}
    w, h = 64, 8 * n
    assert runs["rows"][0].shape == (h, w, 4)
    assert runs["spp"][0].shape == (8, w, 4)
    assert runs["hybrid"][0].shape == (8 * (n // 2), w, 4)
    kw = dict(width=w, height=h, bounces=2, rays_per_pixel=1, skybox=True)
    for name, scene, opts in (
            ("rows", graft_entry._flagship_scene("cpu"), {}),
            ("wide_bvh", graft_entry._wide_bvh_scene("cpu"), {}),
            ("nee_antialias", graft_entry._flagship_scene("cpu"),
             dict(nee=True, antialias=True))):
        want, segs = render_frame(scene, torch.zeros((h, w, 4)), 1,
                                  debug_scale=100.0, **kw, **opts)
        img, got_segs = runs[name]
        assert got_segs == int(segs), name
        np.testing.assert_allclose(img, want.numpy(), rtol=0, atol=ULP_TOL)


def test_dryrun_devices():
    """``n`` distinct cards where the host has them, else the device n
    times (here: no card)."""
    assert graft_entry._mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    if torch.cuda.device_count() < 2:
        assert graft_entry._mesh_devices(2, "cuda") \
            == [torch.device("cuda")] * 2
