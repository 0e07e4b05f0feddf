"""The port's texel atlas and texture sampling against the reference's.

``load_image_rgba`` (the horizontal flip), ``TextureAtlas``,
``_quantize_u8``, ``pack_texels_u8_quads`` and
``downsample_images_to_budget`` give the reference's arrays byte for byte,
texel words whose float32 view is a signaling NaN included (the port keeps
the words as int32, so nothing can quiet them).

The plain ``sample_bilinear_quads`` is held against the reference's at
seeded UVs (negative, past 1, on texel edges and centres, several slots of
odd sizes and a one-texel slot): every channel within 1e-6 (measured: at
most 5.1e-7; 16% of the samples bit-equal). The difference is XLA's: its
CPU backend contracts ``u * w - 0.5`` and the blend into fused
multiply-adds, where the port (and the CUDA kernel, built with
``--fmad=false``) rounds each product. Against a numpy float32 model of the
same expressions without contraction the port is bit-equal, and that is
what pins its order of operations. A byte is scaled by float32(1/255): XLA
compiles the reference's ``/ 255.0`` to that product (its compiled taps
equal the product on every byte, and a true division on half of them).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from ray_tracer_2_tpu.assets import textures as ref_tex
from ray_tracer_2_tpu.kernels import texture as ref_sampler
from ray_tracer_2_tpu_torch.assets import textures as port_tex
from ray_tracer_2_tpu_torch.kernels import texture as port_sampler
from ray_tracer_2_tpu_torch.kernels.texture import INV_255

SHAPES = [(8, 8), (5, 13), (32, 16), (1, 1), (64, 128), (3, 2)]


def _images(seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4)).astype(np.float32) / 255.0
            for h, w in shapes]


def _atlas(images, mod):
    a = mod.TextureAtlas.from_images(images)
    return a, mod.pack_texels_u8_quads(a.texels, a.offsets, a.heights,
                                       a.widths)


def test_load_image_rgba_flips(tmp_path):
    rgb = np.random.default_rng(1).integers(0, 256, (5, 7, 3), np.uint8)
    path = tmp_path / "t.png"
    Image.fromarray(rgb).save(path)
    got, want = port_tex.load_image_rgba(path), ref_tex.load_image_rgba(path)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, 0, :3] * 255.0, rgb[:, -1].astype(np.float32))
    assert np.all(got[..., 3] == 1.0)


@pytest.mark.parametrize("images", [[], [None, None], "seeded"])
def test_atlas_and_quads_byte_equal(images):
    images = _images() + [None] if images == "seeded" else images
    (pa, prows), (ra, rrows) = _atlas(images, port_tex), _atlas(images,
                                                                 ref_tex)
    for f in ("texels", "offsets", "heights", "widths"):
        got, want = getattr(pa, f), getattr(ra, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert prows.dtype == np.int32 and rrows.dtype == np.float32
    assert prows.shape == rrows.shape and prows.tobytes() == rrows.tobytes()
    e = port_tex.TextureAtlas.empty()
    assert e.texels.shape == (64, 4) and not e.texels.any()


def test_signaling_nan_words_survive():
    """Opaque texels with blue >= 128 view as float32 NaNs, these as
    signaling ones (mantissa bit 22 clear): the quad rows keep their bits,
    and the sampler unpacks the bytes."""
    h = w = 8
    texels = np.tile(np.array([[10 / 255, 20 / 255, 128 / 255, 1.0]],
                              np.float32), (h * w, 1))
    offs, hs, ws = (np.array([v], np.int32) for v in (0, h, w))
    got = port_tex.pack_texels_u8_quads(texels, offs, hs, ws)
    want = ref_tex.pack_texels_u8_quads(texels, offs, hs, ws)
    assert got.tobytes() == want.tobytes()
    word = got.view(np.uint32)[0, 0]
    assert word == 0xFF80140A
    assert np.isnan(got.view(np.float32)[0, 0]) and not word & (1 << 22)
    meta = torch.tensor([[0.0, h, w, 0.0]] * 64)
    uv = torch.rand(50, 2, generator=torch.Generator().manual_seed(0)) * 3 - 1
    out = port_sampler.sample_bilinear_quads(
        port_sampler.quads_from_rows(torch.from_numpy(got)), meta,
        torch.zeros(50, dtype=torch.int64), uv)
    expect = torch.tensor([10, 20, 128, 255], dtype=torch.float32) * INV_255
    assert torch.allclose(out, expect.expand(50, 4), atol=1e-6)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_quads_layout_is_the_rows_words(kind):
    """``quads_from_rows`` puts texel t's four quad-row words (columns t & 31
    + 0, 32, 64, 96 of row t >> 5) side by side; ``rows_from_quads`` gives
    the rows back byte for byte."""
    _, rows = _atlas(_images(4), port_tex)
    src = rows if kind == "numpy" else torch.from_numpy(rows)
    quads = port_sampler.quads_from_rows(src)
    back = port_sampler.rows_from_quads(quads)
    quads, back = np.asarray(quads), np.asarray(back)
    assert quads.shape == (rows.shape[0] * 32, 4) and quads.dtype == np.int32
    t = np.arange(quads.shape[0])
    for b in range(4):
        assert np.array_equal(quads[:, b], rows[t >> 5, 32 * b + (t & 31)])
    assert back.tobytes() == rows.tobytes()


def test_quantize_and_downsample_match_reference():
    images = _images(2, [(64, 32), (1, 1), (128, 128), (2, 8)]) + [None]
    texels = np.concatenate([im.reshape(-1, 4) for im in images[:4]])
    assert np.array_equal(port_tex._quantize_u8(texels),
                          ref_tex._quantize_u8(texels))
    with pytest.warns(UserWarning, match="not on the u8/255 grid"):
        port_tex._quantize_u8(np.full((4, 4), 0.3001, np.float32))
    for budget in (10 ** 9, (64 * 32 + 128 * 128) // 4, 1000):
        got = port_tex.downsample_images_to_budget(images, budget)
        want = ref_tex.downsample_images_to_budget(images, budget)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.dtype == w.dtype and np.array_equal(g, w)
    same = port_tex.downsample_images_to_budget(images, 10 ** 9)
    assert all(a is b for a, b in zip(same, images))


def _uvs(rng, n):
    """Seeded UVs: uniform over [-1.5, 2.5), and a quarter on texel centres
    and edges of a 64-texel grid (multiples of 1/128), negative and past 1
    included."""
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    k = n // 4
    uv[:k] = (rng.integers(-128, 384, (k, 2)) / 128.0).astype(np.float32)
    return uv


def _numpy_model(rows, meta, slot, uv):
    """The port's sampler in numpy float32, each product rounded."""
    f32 = np.float32
    m = meta[np.maximum(slot, 0)]
    off, h, w = (m[:, i].astype(np.int64) for i in range(3))
    u = uv[:, 0] - np.floor(uv[:, 0])
    v = uv[:, 1] - np.floor(uv[:, 1])
    xf = u * m[:, 2] - f32(0.5)
    yf = v * m[:, 1] - f32(0.5)
    x0, y0 = np.floor(xf), np.floor(yf)
    tx, ty = (xf - x0)[:, None], (yf - y0)[:, None]
    t = off + np.mod(y0.astype(np.int64), h) * w + np.mod(x0.astype(np.int64),
                                                          w)
    words = rows.view(np.uint32)[t >> 5]
    c = [np.stack([((words[np.arange(len(t)), 32 * b + (t & 31)] >> s)
                    & 255).astype(f32) * f32(INV_255)
                   for s in (0, 8, 16, 24)], 1) for b in range(4)]
    one = f32(1.0)
    top = c[0] * (one - tx) + c[1] * tx
    bot = c[2] * (one - tx) + c[3] * tx
    return top * (one - ty) + bot * ty


def test_sampler_matches_reference():
    a, rows = _atlas(_images(), port_tex)
    meta = np.stack([a.offsets, a.heights, a.widths,
                     np.zeros_like(a.offsets)], 1).astype(np.float32)
    rng = np.random.default_rng(3)
    n = 20_000
    slot = rng.integers(-1, len(SHAPES), n).astype(np.int32)   # -1: clamped
    uv = _uvs(rng, n)
    got = port_sampler.sample_bilinear_quads(
        port_sampler.quads_from_rows(torch.from_numpy(rows)),
        torch.from_numpy(meta),
        torch.from_numpy(slot).to(torch.int64), torch.from_numpy(uv)).numpy()
    want = np.asarray(jax.jit(ref_sampler.sample_bilinear_quads)(
        jnp.asarray(rows.view(np.float32)), jnp.asarray(meta),
        jnp.asarray(slot), jnp.asarray(uv)))
    assert got.dtype == np.float32 and got.shape == (n, 4)
    assert np.abs(got - want).max() <= 1e-6
    assert np.array_equal(got, _numpy_model(rows, meta, slot, uv))
    # the reference's taps, compiled as the render compiles them: its
    # / 255.0 is the product by float32(1/255)
    idx = rng.integers(0, a.texels.shape[0], 1000).astype(np.int32)
    taps = jax.jit(ref_sampler._tap_quad)(jnp.asarray(rows.view(np.float32)),
                                          jnp.asarray(idx))
    col = (idx[:, None] & 31) + np.array([0, 32, 64, 96])
    quad = torch.from_numpy(rows)[idx >> 5].gather(1, torch.from_numpy(col))
    mine = port_sampler.unpack_rgba(quad).numpy()
    for b in range(4):
        assert np.array_equal(mine[:, b], np.asarray(taps[b]))
