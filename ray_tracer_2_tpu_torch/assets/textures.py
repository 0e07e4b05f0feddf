"""Texture loading and the texel atlas (port of
``ray_tracer_2_tpu/assets/textures.py``, whose numpy builders are copied
statement for statement so both packages build the same bytes).

The reference binds a dense 64-slot ``binding_array`` of textures with a
repeat/linear sampler (ray_tracer.rs:139-205). Here, as in the JAX package,
textures live in one flat texel buffer with per-slot (offset, height, width)
rows, and the kernel does its own wrap addressing and bilinear filtering
(``kernels/texture.py``; the CUDA kernel's own copy in
``csrc/megakernel.cu``). Images are flipped horizontally at load — a
reference behaviour scenes depend on (asset.rs:77).

The atlas holds u8 RGBA words as bilinear quads (``pack_texels_u8_quads``).
The reference's paired layout (``pack_texels_u8_pairs``,
``RT2_TEX_LAYOUT=pairs``) was a TPU gather tuning that samples the same
image, and is not ported (ROADMAP Queue 1 item 10). Where the reference
keeps the words bit-cast to float32, the port keeps them as int32: the same
bytes, on which no float operation can quiet a signaling NaN.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ray_tracer_2_tpu_torch.config import MAX_TEXTURES


def load_image_rgba(path) -> np.ndarray:
    """Decode to (H, W, 4) float32 in [0,1], flipped horizontally
    (asset.rs:77). PIL is imported here, at the first file decoded."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGBA")
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return arr[:, ::-1, :].copy()  # horizontal flip


@dataclasses.dataclass
class TextureAtlas:
    """Host-side staging of the flat texel buffer and its slot tables."""

    texels: np.ndarray    # (N_texels, 4) float32
    offsets: np.ndarray   # (MAX_TEXTURES,) int32 — start texel per slot
    heights: np.ndarray   # (MAX_TEXTURES,) int32
    widths: np.ndarray    # (MAX_TEXTURES,) int32

    @staticmethod
    def from_images(images: list[np.ndarray | None]) -> "TextureAtlas":
        """Build from per-slot images (None ⇒ 1x1 black, matching the dummy
        fill of ray_tracer.rs:276-296)."""
        assert len(images) <= MAX_TEXTURES
        offsets = np.zeros(MAX_TEXTURES, np.int32)
        heights = np.ones(MAX_TEXTURES, np.int32)
        widths = np.ones(MAX_TEXTURES, np.int32)
        chunks = []
        cursor = 0
        for slot in range(MAX_TEXTURES):
            img = images[slot] if slot < len(images) else None
            if img is None:
                img = np.zeros((1, 1, 4), np.float32)
            h, w = img.shape[:2]
            offsets[slot] = cursor
            heights[slot] = h
            widths[slot] = w
            chunks.append(img.reshape(-1, 4).astype(np.float32))
            cursor += h * w
        return TextureAtlas(np.concatenate(chunks, axis=0), offsets, heights,
                            widths)

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas.from_images([])


def downsample_images_to_budget(images: list, budget_texels: int) -> list:
    """Uniformly downscale oversized texture sets to ``budget_texels`` total
    (area-preserving ratio, PIL BOX filter = exact area average; output
    stays on the u8/255 grid). Off unless ``RT2_TEX_BUDGET_MB`` is set
    (``scene/render_scene.py``): the reference samples full-resolution
    textures (ray_tracer.wgsl:455-459). Images at-or-under budget pass
    through untouched; PIL is imported only when something is scaled."""
    total = sum(int(im.shape[0]) * int(im.shape[1])
                for im in images if im is not None)
    if total <= budget_texels:
        return images
    from PIL import Image

    r = (budget_texels / total) ** 0.5
    out = []
    for im in images:
        if im is None or im.shape[0] * im.shape[1] <= 16:
            out.append(im)
            continue
        h, w = im.shape[:2]
        nh = max(1, int(round(h * r)))
        nw = max(1, int(round(w * r)))
        if (nh, nw) == (h, w):
            out.append(im)
            continue
        u8 = (np.clip(im, 0.0, 1.0) * 255.0).round().astype(np.uint8)
        # per-channel resize: PIL premultiplies alpha for RGBA resizes,
        # which corrupts RGB by a bit even at constant alpha
        chans = [np.asarray(Image.fromarray(u8[..., c], "L")
                            .resize((nw, nh), Image.BOX), dtype=np.float32)
                 for c in range(4)]
        out.append(np.stack(chans, axis=-1) / 255.0)
    return out


def _quantize_u8(texels: np.ndarray) -> np.ndarray:
    u8 = (np.clip(texels, 0.0, 1.0) * 255.0).round().astype(np.uint32)
    err = np.abs(np.clip(texels, 0.0, 1.0) * 255.0 - u8)
    if err.size and float(err.max()) > 1e-3:
        import warnings
        warnings.warn(
            "texel pack: input texels are not on the u8/255 grid "
            f"(max quantization error {err.max() / 255.0:.4g}) — HDR/float "
            "textures degrade silently in the u8 atlas", stacklevel=3)
    return u8


def pack_texels_u8_quads(texels: np.ndarray, offsets: np.ndarray,
                         heights: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """(X, 4) f32 texels -> (ceil(X/32), 128) int32 rows of bilinear QUADS
    (the reference's rows, viewed as int32): texel t = (x, y) of its slot
    lives at row t >> 5, column block t & 31:

      col       t & 31   word (x, y)
      col  32 + t & 31   word ((x+1) %% w, y)       x-neighbor, wrap baked
      col  64 + t & 31   word (x, (y+1) %% h)       y-neighbor
      col  96 + t & 31   word ((x+1) %% w, (y+1) %% h)

    A word is R | G << 8 | B << 16 | A << 24 of the u8-quantized texel."""
    x = texels.shape[0]
    u8 = _quantize_u8(texels)
    words = (u8[:, 0] | (u8[:, 1] << 8) | (u8[:, 2] << 16)
             | (u8[:, 3] << 24)).astype(np.uint32)
    x1 = words.copy()
    y1 = words.copy()
    xy = words.copy()
    for off, h, w in zip(offsets, heights, widths):
        off, h, w = int(off), int(h), int(w)
        if off >= x:
            continue
        blk = words[off:off + h * w].reshape(h, w)
        x1[off:off + h * w] = np.roll(blk, -1, axis=1).reshape(-1)
        y1[off:off + h * w] = np.roll(blk, -1, axis=0).reshape(-1)
        xy[off:off + h * w] = np.roll(blk, (-1, -1), axis=(0, 1)).reshape(-1)
    xp = -(-max(x, 1) // 32) * 32
    pad = np.zeros(xp - x, np.uint32)
    planes = [np.concatenate([p, pad]).reshape(-1, 32)
              for p in (words, x1, y1, xy)]
    return np.concatenate(planes, axis=1).view(np.int32)
