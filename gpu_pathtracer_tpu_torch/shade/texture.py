"""Texture and environment-map fetch: bilinear, wrap-repeat then edge clamp.

The port of gpu_pathtracer_tpu/shade/texture.py (the reference's
GetTexel / getTexel, pathtracer.cu:324-359, and Infinite's lookup,
infinite.h:66-94). Each lookup reads the four texels around (w u, h v)
and blends them bilinearly. A texel coordinate wraps with a floor
modulo (negative coordinates wrap too) and is then clamped to the
image, so the +1 neighbour of the last column is column 0: the rule the
JAX package bakes into its corner rows (flatten.py:535-551). Textures
are read from the flat uint8 atlas `tex_data` [T, 3] (linear values
quantised at load, texture.h:15-27) and scaled by 1/255 with a true
division, so csrc/pt_fused.cu, which fetches the same four texels per
thread, rounds every value alike. The JAX package's corner-packed
`tex_corners` (a TPU row-gather layout) is not ported.
"""

from __future__ import annotations

import torch


def _wrap(i, n):
    """Texel index i wrapped into [0, n) by floor modulo, then clamped."""
    return torch.clamp(torch.remainder(i, n), torch.zeros_like(n), n - 1)


def _bilinear(xx, yy, w, h, fetch):
    """Blend the four texels around (xx, yy) of a w x h image;
    fetch(x, y) -> [N, 3] reads wrapped texel coordinates."""
    x = torch.floor(xx).to(torch.int32)
    y = torch.floor(yy).to(torch.int32)
    dx = torch.abs(xx - x)[..., None]
    dy = torch.abs(yy - y)[..., None]
    x0, x1 = _wrap(x, w), _wrap(x + 1, w)
    y0, y1 = _wrap(y, h), _wrap(y + 1, h)
    c00, c10 = fetch(x0, y0), fetch(x1, y0)
    c01, c11 = fetch(x0, y1), fetch(x1, y1)
    return (1 - dy) * ((1 - dx) * c00 + dx * c10) \
        + dy * ((1 - dx) * c01 + dx * c11)


def get_texel(scene, mat_idx, uv):
    """The diffuse colour of material `mat_idx` at `uv` [N, 2]: the
    bilinear texel for a textured material, its constant diffuse
    otherwise."""
    diffuse = scene.m_diffuse[mat_idx.long()]
    tex_idx = scene.m_tex_idx[mat_idx.long()]
    has_tex = tex_idx >= 0
    ti = torch.where(has_tex, tex_idx, 0).long()
    w = scene.tex_w[ti]
    h = scene.tex_h[ti]
    off = scene.tex_offset[ti].long()
    scale = torch.full((), 255.0, device=uv.device)   # a true division

    def fetch(x, y):
        return scene.tex_data[off + (y * w + x).long()].float() / scale

    tex = _bilinear(w.float() * uv[..., 0], h.float() * uv[..., 1], w, h,
                    fetch)
    return torch.where(has_tex[..., None], tex, diffuse)


def env_lookup(scene, uv):
    """Bilinear environment-map fetch at uv [N, 2] in [0, 1]^2."""
    h, w, _ = scene.env_data.shape
    data = scene.env_data.reshape(-1, 3)
    wt = torch.full_like(uv[..., 0], w, dtype=torch.int32)
    ht = torch.full_like(uv[..., 0], h, dtype=torch.int32)
    return _bilinear(w * uv[..., 0], h * uv[..., 1], wt, ht,
                     lambda x, y: data[(y * w + x).long()])
