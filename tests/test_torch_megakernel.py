"""The port's persistent render against the reference's.

The plain PyTorch ``render_persistent`` (the CPU path of the port) is held
against JAX ``render_persistent(fused_boundary=True)`` — the TPU main path,
run here through the Pallas interpreter — on the asset-free wide-BVH scene
at 32x16, from identical scene tables. Classes (as in
tests/test_fused_boundary.py, whose XLA and fused boundaries differ the
same way):

* bounces=0: no chaotic feedback — segment counts exact, >= 99% of pixels
  within 1e-5 (a silhouette pixel may flip on a last-ulp camera ray).
* bounces=3: mul+add chains round differently (XLA contracts some into
  FMAs), so paths diverge: >= 70% of pixels within 1e-5 in every frame, and
  the segment count over four frames within 1%.
* rpp=2 with antialias at bounces=0: segments exact, >= 90% of pixels
  within 1e-5 (a flipped first sample moves the second sample's jitter).

The port follows the XLA boundary's op order, so against
``fused_boundary=False`` it is held tighter: >= 99% of pixels within 1e-5
and segments within 0.5% at bounces=3. The bounced classes live in
tests/test_torch_megakernel_bounced.py (a file per xdist worker).
"""
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu_torch.kernels.megakernel import CUDA_MEGAKERNEL
from torch_bridge import (
    H, W, frac_within, port_render as _port, ref_render as _ref, torch_scene,
    wide_bvh_render_scene,
)


@pytest.fixture(scope="module")
def scenes_():
    rs = wide_bvh_render_scene()
    return rs, torch_scene(rs)


def test_primary_class(scenes_):
    rs, ts = scenes_
    a, sa = _ref(rs, 1)
    b, sb = _port(ts, 1)
    assert b.shape == (H, W, 4)
    assert np.isfinite(b).all()
    assert sa == sb == W * H
    assert frac_within(a, b) >= 0.99


def test_antialias_two_samples(scenes_):
    rs, ts = scenes_
    a, sa = _ref(rs, 1, rays_per_pixel=2, antialias=True)
    b, sb = _port(ts, 1, rays_per_pixel=2, antialias=True)
    assert sa == sb == 2 * W * H
    assert frac_within(a, b) >= 0.90


def test_row_window_is_a_slice_of_the_frame(scenes_):
    """Seeds derive from global pixel ids, so rendering rows 4..11 alone
    gives exactly those rows of the whole frame."""
    _, ts = scenes_
    full, _ = _port(ts, 2, bounces=2)
    part, _ = _port(ts, 2, bounces=2, row_start=4, rows=8)
    assert np.array_equal(full[4:12], part)


def test_cpu_path_never_launches_the_kernel(scenes_):
    _, ts = scenes_
    before = CUDA_MEGAKERNEL.launches
    _port(ts, 0)
    assert CUDA_MEGAKERNEL.launches == before


@pytest.mark.slow
def test_converged_mean(scenes_):
    """Eight progressive frames: the per-pixel chaos averages out and the
    mean image converges to the reference's (RMSE of the per-pixel max
    channel error < 0.15, as tests/test_fused_boundary.py holds the two
    JAX boundaries)."""
    rs, ts = scenes_
    kw = dict(bounces=4, width=96, height=64)
    acc_ref = np.zeros((64, 96, 4))
    acc_port = np.zeros((64, 96, 4))
    for f in range(8):
        acc_ref += _ref(rs, f, lanes=512, **kw)[0]
        acc_port += _port(ts, f, **kw)[0]
    err = np.abs(acc_ref / 8 - acc_port / 8).max(axis=-1)
    assert np.sqrt((err ** 2).mean()) < 0.15
