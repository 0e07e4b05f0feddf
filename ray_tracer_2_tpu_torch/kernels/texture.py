"""Texture sampling, the plain version (port of
``ray_tracer_2_tpu/kernels/texture.py:sample_bilinear_quads``; the CUDA
kernel's copy is ``sample_quads`` in ``csrc/megakernel.cu``).

The reference's repeat-addressed bilinear ``textureSampleLevel``
(ray_tracer.rs:197-205, ray_tracer.wgsl:455) becomes explicit wrap
addressing and one fetch of a quad: the texel and its wrapped x, y and xy
neighbours, baked at pack time (``assets/textures.py:pack_texels_u8_quads``).
The reference's quad rows keep a texel's four words 32 words apart; the
port's scene holds the same words one texel a row of four
(``TorchScene.tex_quads``, ``quads_from_rows``), the layout the CUDA
kernel reads as one 16-byte load, so one copy of the atlas serves both
versions. No hardware filtering: a texture unit blends with fixed-point
weights, so the blend is written out in float32 in the reference's order.

The atlas words are u8 RGBA payloads held as int32; they are unpacked with
integer shifts and never pass through a float operation. A channel is its
byte times float32(1/255): the reference writes ``/ 255.0``, which XLA
compiles to that multiply (on the CPU every byte's result equals the
multiply's, and half of them differ from a true division).
"""
from __future__ import annotations

import numpy as np
import torch

#: float32(1/255), the factor of the reference's compiled ``/ 255.0``
INV_255 = float(np.float32(1.0 / 255.0))


def unpack_rgba(words: torch.Tensor) -> torch.Tensor:
    """(..., ) int32 words R | G << 8 | B << 16 | A << 24 -> (..., 4)
    float32 channels in [0, 1]."""
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32,
                          device=words.device)
    return ((words[..., None] >> shifts) & 0xFF).to(torch.float32) * INV_255


def quads_from_rows(rows):
    """The reference's (R, 128) quad rows -> (32 R, 4): texel t's word and
    its x, y and xy neighbours' side by side (numpy array or tensor)."""
    return rows.reshape(-1, 4, 32).swapaxes(1, 2).reshape(-1, 4)


def rows_from_quads(quads):
    """Inverse of ``quads_from_rows``: the reference's quad rows."""
    return quads.reshape(-1, 32, 4).swapaxes(1, 2).reshape(-1, 128)


def sample_bilinear_quads(quads: torch.Tensor, tex_meta: torch.Tensor,
                          slot: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with repeat wrap from the quad atlas: ``quads``
    (X, 4) int32, one texel a row (``quads_from_rows``), ``tex_meta``
    (64, 4) float32 slot rows
    (offset, height, width, 0), ``slot`` (B,) integer (clamped to >= 0, as
    the reference's caller's mask leaves it), ``uv`` (B, 2). Returns (B, 4)
    float32. The offsets pass through float32, as in the reference: exact
    below 2^24 texels."""
    meta = tex_meta[torch.clamp(slot, min=0).long()]
    off = meta[:, 0].to(torch.int64)
    h = meta[:, 1].to(torch.int64)
    w = meta[:, 2].to(torch.int64)
    hf, wf = meta[:, 1], meta[:, 2]
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    xf = u * wf - 0.5
    yf = v * hf - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    tx = (xf - x0)[:, None]
    ty = (yf - y0)[:, None]
    # floor modulo (jnp.mod): x0 = -1 wraps to w - 1
    x0w = torch.remainder(x0.to(torch.int64), w)
    y0w = torch.remainder(y0.to(torch.int64), h)
    c00, c01, c10, c11 = unpack_rgba(quads[off + y0w * w + x0w]).unbind(1)
    top = c00 * (1.0 - tx) + c01 * tx
    bot = c10 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty
