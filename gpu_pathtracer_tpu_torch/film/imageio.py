"""Image output: PNG and a minimal EXR writer, numpy + zlib + struct only.

The port's counterpart of gpu_pathtracer_tpu/film/imageio.py without PIL:
- `save_png` clamps, converts to 8-bit and flips V exactly like the JAX
  package's `save_png` (imageio.py:33-39; the reference's SavePng,
  imageio.cpp:100-120), then encodes an RGB PNG with zlib;
- `save_exr` is a copy of the JAX package's scanline HALF/ZIP writer
  (imageio.py:168-227);
- `read_density_file` reads a heterogeneous medium's text density grid
  (imageio.py:229-243).
Texture and EXR loading are not ported yet (ROADMAP.md, still to port:
item 3).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PIX_HALF = 1
_COMP_ZIP = 3


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(rgb8: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    h, w, _ = rgb8.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8),
         np.ascontiguousarray(rgb8, np.uint8).reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_png(path: str, image: np.ndarray, flip: bool = True) -> None:
    """float32 [H, W, 3] (display-ready, already tonemapped) -> PNG."""
    arr = np.clip(np.asarray(image), 0.0, 1.0)
    if flip:
        arr = arr[::-1]
    with open(path, "wb") as f:
        f.write(encode_png((arr * 255.0 + 0.5).astype(np.uint8)))


def _predictor_encode(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = arr.shape[0]
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    d = inter.astype(np.int32)
    d[1:] = d[1:] - d[:-1]
    d = ((d + 128) % 256).astype(np.uint8)
    return d.tobytes()


def save_exr(path: str, image: np.ndarray) -> None:
    """Save float32 [H, W, 3] as scanline HALF EXR with ZIP compression."""
    img = np.asarray(image, np.float32)
    height, width, _ = img.shape
    half = img.astype(np.float16)

    header = b""

    def attr(name: str, typ: str, val: bytes) -> bytes:
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<i", len(val)) + val)

    chan = b""
    for c in "BGR":  # alphabetical storage order
        chan += c.encode() + b"\x00" + struct.pack("<i", _PIX_HALF) + \
            b"\x00" * 4 + struct.pack("<ii", 1, 1)
    chan += b"\x00"
    header += attr("channels", "chlist", chan)
    header += attr("compression", "compression", bytes([_COMP_ZIP]))
    box = struct.pack("<4i", 0, 0, width - 1, height - 1)
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    lines_per_block = 16
    n_blocks = (height + lines_per_block - 1) // lines_per_block
    blocks = []
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        nlines = min(lines_per_block, height - y0)
        rows = []
        for li in range(nlines):
            row = b""
            for ci in [2, 1, 0]:  # B, G, R
                row += half[y0 + li, :, ci].tobytes()
            rows.append(row)
        raw = b"".join(rows)
        comp = zlib.compress(_predictor_encode(raw))
        if len(comp) >= len(raw):
            comp = raw
        blocks.append((y0, comp))

    with open(path, "wb") as f:
        f.write(struct.pack("<iI", 20000630, 2))
        f.write(header)
        table_off = f.tell() + 8 * n_blocks
        offs = []
        pos = table_off
        for y0, comp in blocks:
            offs.append(pos)
            pos += 8 + len(comp)
        f.write(struct.pack(f"<{n_blocks}Q", *offs))
        for y0, comp in blocks:
            f.write(struct.pack("<iI", y0, len(comp)))
            f.write(comp)


def read_density_file(path: str, nx: int, ny: int, nz: int) -> np.ndarray:
    """Text density grid, one float per line (reference medium.h:237-245)
    -> [nz, ny, nx] float32, index order d[z*ny*nx + y*nx + x]
    (medium.h:174-177)."""
    data = np.loadtxt(path, dtype=np.float32).reshape(-1)
    if data.size != nx * ny * nz:
        raise ValueError(f"{path}: expected {nx * ny * nz} density "
                         f"samples, got {data.size}")
    return data.reshape(nz, ny, nx)
