"""Textures in the port: the PNG decoder, texture and EXR loading, and the
bilinear texel and environment fetches, against PIL and the JAX package.

The decoder is exact: it must give PIL's bytes. PIL is used only here,
as the reference; the port reads PNGs without it. The fetches must equal
the JAX package's (its corner-row texel gather, its four-tap environment
lookup) within 1e-6 on random uv in [-3, 3]^2, so wrapping across
negative and > 1 coordinates is covered.
"""

import io
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity as tp
from gpu_pathtracer_tpu.film import imageio as jio
from gpu_pathtracer_tpu.shade import texture as jtex
from gpu_pathtracer_tpu_torch.film import imageio as tio
from gpu_pathtracer_tpu_torch.shade import texture as ttex

GRAPH_PAPER = tp.REPO / "scenes" / "teapot" / "graph_paper.png"
SKY = tp.REPO / "scenes" / "env" / "sky.exr"
TEXTURED = tp.REPO / "scenes" / "cornell_port" / "textured.json"
MIXED = tp.REPO / "scenes" / "env_port" / "mixed.json"


def test_png_decoder_matches_pil_on_graph_paper():
    data = GRAPH_PAPER.read_bytes()
    np.testing.assert_array_equal(tio.decode_png(data),
                                  np.asarray(Image.open(GRAPH_PAPER)))


# PIL mode -> PNG colour type 0, 2, 3, 4, 6
@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_png_decoder_matches_pil_per_colour_type(mode):
    rng = np.random.default_rng(11)
    ch = {"L": 1, "RGB": 3, "P": 1, "LA": 2, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (37, 53, ch), dtype=np.uint8)
    arr[:, :20] //= 16                    # smooth runs: other filters win
    if mode == "P":
        img = Image.fromarray(arr[..., 0], "P")
        img.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
    else:
        img = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    got = tio.decode_png(buf.getvalue())
    ref = np.asarray(img.convert("RGB") if mode == "P" else img)
    np.testing.assert_array_equal(got, ref.reshape(got.shape))


def _png_with_filters(img):
    """An RGB PNG of img [H, W, 3] u8 whose row y uses filter y % 5."""
    h, w, _ = img.shape
    bpp, rows = 3, []
    prev = np.zeros(w * 3, np.int64)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = y % 5
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        rows.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8)
                    .tobytes())
        prev = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_decoder_undoes_all_five_row_filters():
    img = np.random.default_rng(12).integers(0, 256, (15, 9, 3),
                                             dtype=np.uint8)
    data = _png_with_filters(img)
    np.testing.assert_array_equal(tio.decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)


def _patch_ihdr(data, depth=8, interlace=0):
    """A PNG's bytes with its IHDR bit depth and interlace method set."""
    w, h, _, ctype, comp, filt, _ = struct.unpack(">IIBBBBB", data[16:29])
    body = struct.pack(">IIBBBBB", w, h, depth, ctype, comp, filt, interlace)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


@pytest.mark.parametrize("what", ["16-bit", "interlaced", "not a png"])
def test_png_decoder_refuses_what_it_does_not_read(what):
    img = np.random.default_rng(13).integers(0, 256, (8, 8, 3),
                                             dtype=np.uint8)
    data = _png_with_filters(img)
    if what == "16-bit":
        data = _patch_ihdr(data, depth=16)
    elif what == "interlaced":
        data = _patch_ihdr(data, interlace=1)
    else:
        data = b"GIF89a" + data[6:]
    with pytest.raises(ValueError):
        tio.decode_png(data)


def test_load_texture_matches_jax():
    """V flipped, sRGB -> linear by pow 2.2 in float32: bit-equal."""
    got = tio.load_texture(str(GRAPH_PAPER))
    ref = jio.load_texture(str(GRAPH_PAPER))
    assert got.dtype == np.float32 and got.shape == (2048, 2048, 3)
    np.testing.assert_array_equal(got, ref)


def test_load_exr_matches_jax(tmp_path):
    np.testing.assert_array_equal(tio.load_exr(str(SKY)),
                                  jio.load_exr(str(SKY)))
    # and the port's writer round-trips through both readers
    img = np.random.default_rng(14).uniform(0, 4, (19, 23, 3))
    path = tmp_path / "r.exr"
    tio.save_exr(str(path), img)
    np.testing.assert_array_equal(tio.load_exr(str(path)),
                                  img.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(jio.load_exr(str(path)),
                                  tio.load_exr(str(path)))


@pytest.fixture(scope="module")
def textured_scenes():
    """(JAX scene, JAX static, port scene, port static) of the textured
    Cornell box and the mixed sky scene (numpy BVH builders)."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, path in (("textured", TEXTURED), ("mixed", MIXED)):
            jd, js = tp.jax_flatten(path, mp, size=16)
            out[name] = (jd, js, *tp.port_scene_from_jax(jd, js))
    finally:
        mp.undo()
    return out


def _uv(n, seed):
    return np.random.default_rng(seed).uniform(-3, 3, (n, 2)) \
        .astype(np.float32)


@pytest.mark.parametrize("name", ["textured", "mixed"])
def test_get_texel_matches_jax(textured_scenes, name):
    jd, js, td, ts = textured_scenes[name]
    n = 4096
    uv = _uv(n, 15)
    # every material, textured or not, on random uv
    mats = np.arange(n, dtype=np.int32) % td.m_type.shape[0]
    ref = np.asarray(jtex.get_texel(jd, jnp.asarray(mats), jnp.asarray(uv),
                                    True))
    got = ttex.get_texel(td, torch.as_tensor(mats),
                         torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    textured = td.m_tex_idx.numpy()[mats] >= 0
    assert textured.any() and (~textured).any()
    assert np.ptp(got[textured]) > 0.1   # the texels vary


def test_env_lookup_matches_jax(textured_scenes):
    jd, _, td, _ = textured_scenes["mixed"]
    uv = _uv(4096, 16)
    ref = np.asarray(jtex.env_lookup(jd, jnp.asarray(uv)))
    got = ttex.env_lookup(td, torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert got.max() > 1.0   # the sun's texels are in reach
