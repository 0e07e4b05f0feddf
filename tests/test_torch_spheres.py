"""The port's small-scene path against the reference's ``pallas_spheres``.

``pack_tables`` is held against the reference's ``_pack_tables`` to within
one ulp (its TPU padding mapped away), and ``render_spheres`` on CPU
tensors — the plain PyTorch version — against
``render_spheres_pallas(interpret=True)`` at 32x16 from identical scene
tables. At bounces=0 there is no chaotic feedback: segments exact and
>= 99.9% of pixels within 1e-5 (measured: every pixel, max error 1.2e-7,
on metal, random_balls and room). The bounced classes are in
tests/test_torch_spheres_renderer.py (a file per xdist worker).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracer_2_tpu.math.transform as ref_transform
from ray_tracer_2_tpu.scene.definition import SphereDef as RefSphereDef
from ray_tracer_2_tpu.kernels.trace import _reflectance as ref_reflectance
from ray_tracer_2_tpu.kernels.pallas_spheres import (
    F_ROWS, F_ROWS_SPHERES, _pack_tables, render_spheres_pallas,
)
from ray_tracer_2_tpu.scene import scenes as ref_scenes
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.kernels import spheres
from ray_tracer_2_tpu_torch.kernels.trace import reflectance
from ray_tracer_2_tpu_torch.kernels.spheres import (
    CUDA_SPHERES, MAX_TRIS, eligible, pack_tables, render_spheres,
)
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
from torch_bridge import H, W, frac_within, torch_scene
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

_SCENES = {}


def _room_reflected():
    """room with every mesh under a reflecting transform (scale -1 on x):
    the bake must swap v1/v2 and n1/n2."""
    s = ref_scenes.room()
    for e in s.entities:
        if not isinstance(e.primitive, RefSphereDef):
            e.transform = ref_transform.Transform(scale=[-1.0, 1.0, 1.0])
    return s


def scene_pair(name):
    """(reference RenderScene, port TorchScene from its tables), cached."""
    if name not in _SCENES:
        build = (_room_reflected if name == "room_reflected"
                 else getattr(ref_scenes, name))
        rs = ref_instantiate(build()).render_scene
        _SCENES[name] = rs, torch_scene(rs)
    return _SCENES[name]


def ref_spheres(rs, frames, **over):
    kw = dict(width=W, height=H, bounces=0, rays_per_pixel=1, skybox=True)
    kw.update(over)
    img, segs = render_spheres_pallas(rs, jnp.int32(frames), interpret=True,
                                      **kw)
    return np.asarray(img), int(float(segs))


def port_spheres(ts, frames, **over):
    kw = dict(width=W, height=H, bounces=0, rays_per_pixel=1, skybox=True)
    kw.update(over)
    img, segs = render_spheres(ts, frames, **kw)
    assert img.dtype == torch.float32 and segs.dtype == torch.int64
    return img.numpy(), int(segs)


@pytest.mark.parametrize("name", ["balls", "random_balls", "room",
                                  "room_reflected"])
def test_pack_tables_match_reference(name):
    rs, ts = scene_pair(name)
    sph, tri, mT, S_pad, _T_pad, _ = _pack_tables(rs)
    sph, tri, mT = np.asarray(sph), np.asarray(tri), np.asarray(mT)
    tab = pack_tables(ts)
    S, T = tab.n_spheres, tab.n_tris
    assert (S, T) == (rs.n_spheres, spheres.tri_count(ts))
    assert mT.shape[0] == (F_ROWS if T else F_ROWS_SPHERES)
    got_s, got_t, got_f = (x.numpy() for x in (tab.spheres, tab.tris,
                                               tab.fields))
    np.testing.assert_array_max_ulp(got_s[:, :5], sph[:S, :5], maxulp=1)
    np.testing.assert_array_max_ulp(got_t[:, :13], tri[:T, :13], maxulp=1)
    nf = mT.shape[0]
    np.testing.assert_array_max_ulp(got_f[:S, :nf], mT[:, :S].T, maxulp=1)
    np.testing.assert_array_max_ulp(got_f[S:, :nf],
                                    mT[:, S_pad:S_pad + T].T, maxulp=1)
    assert not got_s[:, 5:].any() and not got_t[:, 13:].any()
    assert not got_f[:, nf:].any()
    assert pack_tables(ts) is tab           # packed once per scene


def test_reflectance_matches_reference():
    """Schlick with (1 - cos)^5 as JAX's products: bit for bit."""
    rs = np.random.default_rng(0)
    cos = rs.uniform(-0.2, 1.0, 100_000).astype(np.float32)
    ior = rs.uniform(0.5, 2.5, 100_000).astype(np.float32)
    want = np.asarray(ref_reflectance(jnp.asarray(cos), jnp.asarray(ior)))
    got = reflectance(torch.from_numpy(cos), torch.from_numpy(ior)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["metal", "random_balls", "room"])
def test_primary_class(name):
    rs, ts = scene_pair(name)
    a, sa = ref_spheres(rs, 1)
    b, sb = port_spheres(ts, 1)
    assert b.shape == (H, W, 4) and np.isfinite(b).all()
    assert sa == sb == W * H
    assert frac_within(a, b) >= 0.999


def test_row_window_is_a_slice_of_the_frame():
    """Seeds derive from global pixel ids and the camera from the full
    image, so rows 3..12 alone are those rows of the frame: bit for bit at
    bounces=0, and within 1e-6 with bounces (PyTorch's CPU log/cos round a
    vector body and its scalar tail apart by an ulp, and the window moves
    pixels between the two; measured 6e-8 on 2 pixels)."""
    _, ts = scene_pair("room")
    kw = dict(rays_per_pixel=2, row_start=3, rows=10)
    full, _ = port_spheres(ts, 2, rays_per_pixel=2)
    part, segs = port_spheres(ts, 2, **kw)
    assert np.array_equal(full[3:13], part) and segs == 2 * 10 * W
    full, _ = port_spheres(ts, 2, bounces=2, rays_per_pixel=2)
    part, _ = port_spheres(ts, 2, bounces=2, **kw)
    assert np.abs(full[3:13] - part).max() < 1e-6


def test_cpu_path_never_launches_the_kernel():
    _, ts = scene_pair("metal")
    before = CUDA_SPHERES.launches
    port_spheres(ts, 0, bounces=1)
    assert CUDA_SPHERES.launches == before


def test_eligibility():
    for build in (scenes.balls, scenes.metal, scenes.random_balls,
                  scenes.room):
        assert eligible(instantiate_scene(build()))
    # more than MAX_TRIS triangles: the brute-force/BVH route
    many = instantiate_scene(scenes.wide_bvh_scene(lat=4, lon=9))
    assert spheres.tri_count(many) == 72 > MAX_TRIS
    assert not eligible(many)
    # a textured material row (built directly: earthmap.png is not in the
    # repository): flag TEXTURE, or a diffuse texture index
    ts = instantiate_scene(scenes.metal())
    for col, value in ((21, 2.0), (22, 0.0)):
        rows = ts.mat_rows.clone()
        rows[1, col] = value
        assert not eligible(dataclasses.replace(ts, mat_rows=rows))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_spheres(instantiate_scene(scenes.main_path_scene(8, 8)), 0,
                       width=8, height=4, bounces=0, rays_per_pixel=1,
                       skybox=True)
