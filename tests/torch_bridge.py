"""Shared helpers of the port's tests (tests/test_torch_*.py): bring a scene
of the JAX package over to the PyTorch port through numpy, so both render
from identical tables."""
from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import torch

from ray_tracer_2_tpu.kernels.megakernel import \
    render_persistent as _ref_render_persistent
from ray_tracer_2_tpu_torch.kernels.megakernel import render_persistent
from ray_tracer_2_tpu_torch.scene.render_scene import (
    FIELDS, STATICS, TorchScene,
)

#: the image size the render comparisons use
W, H = 32, 16
_JITS = {}


def torch_scene(rs) -> TorchScene:
    """The port's scene for a reference ``RenderScene`` (CPU tensors)."""
    return TorchScene.from_numpy({f: np.asarray(getattr(rs, f))
                                  for f in FIELDS},
                                 {k: getattr(rs, k) for k in STATICS})


def wide_bvh_render_scene():
    """The reference's asset-free wide-BVH scene (__graft_entry__)."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from __graft_entry__ import _wide_bvh_scene
    return _wide_bvh_scene()


def frac_within(a, b, tol: float = 1e-5) -> float:
    """Share of pixels whose four channels all agree within ``tol``."""
    err = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    return float((err < tol).mean())


def ref_render(rs, frames, fused=True, **over):
    """JAX ``render_persistent`` at W x H (128 lanes, unroll 2; the fused
    boundary runs in the Pallas interpreter). Returns (image, segments)."""
    kw = dict(width=W, height=H, bounces=0, rays_per_pixel=1, skybox=True,
              lanes=128, unroll=2)
    kw.update(over)
    key = (fused, tuple(sorted(kw.items())))
    if key not in _JITS:
        _JITS[key] = jax.jit(lambda s, f: _ref_render_persistent(
            s, f, fused_boundary=fused, **kw))
    img, segs = _JITS[key](rs, frames)
    return np.asarray(img), int(float(segs))


def port_render(ts, frames, **over):
    """The port's ``render_persistent`` at W x H. Returns (image, segments)."""
    kw = dict(width=W, height=H, bounces=0, rays_per_pixel=1, skybox=True)
    kw.update(over)
    img, segs = render_persistent(ts, frames, **kw)
    assert img.dtype == torch.float32 and segs.dtype == torch.int64
    return img.numpy(), int(segs)
