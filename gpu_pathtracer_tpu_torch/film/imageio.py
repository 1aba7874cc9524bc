"""Image I/O: PNG and a minimal EXR codec, numpy + zlib + struct only.

The port's counterpart of gpu_pathtracer_tpu/film/imageio.py without PIL:
- `decode_png` reads 8-bit, non-interlaced PNGs of colour types 0, 2, 3,
  4 and 6 with all five row filters; anything else raises;
- `read_png_rgb` gives what PIL's convert("RGB") gives: grey is
  replicated, a palette is looked up, alpha is dropped;
- `load_texture` reads through it, flips V and converts sRGB -> linear
  with pow 2.2 in float32, like the JAX package's (imageio.py:22-30);
- `save_png` clamps, converts to 8-bit and flips V exactly like the JAX
  package's `save_png` (imageio.py:33-39; the reference's SavePng,
  imageio.cpp:100-120), then encodes an RGB PNG with zlib;
- `load_exr` / `save_exr` are copies of the JAX package's scanline
  HALF/FLOAT, NO/ZIPS/ZIP codec (imageio.py:82-227);
- `read_density_file` reads a heterogeneous medium's text density grid
  (imageio.py:229-243).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PIX_UINT, _PIX_HALF, _PIX_FLOAT = 0, 1, 2
_COMP_NO, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples


def _unfilter_rows(raw: np.ndarray, h: int, stride: int,
                   bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of the
    inflated image data -> [h, stride] uint8."""
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f = int(raw[y, 0])
        line = raw[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 1:   # Sub: a running sum per byte lane, modulo 256
            cur = np.empty(stride, np.uint8)
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(line[k::bpp], dtype=np.uint64) & 255
        elif f == 2:   # Up
            cur = line + prev
        elif f in (3, 4):   # Average, Paeth: each byte needs its left one
            cur = line.astype(np.int64)
            up = prev.astype(np.int64)
            c = cur.tolist()
            b = up.tolist()
            for i in range(stride):
                left = c[i - bpp] if i >= bpp else 0
                if f == 3:
                    c[i] = (c[i] + ((left + b[i]) >> 1)) & 255
                    continue
                ul = b[i - bpp] if i >= bpp else 0
                p = left + b[i] - ul
                pa, pb, pc = abs(p - left), abs(p - b[i]), abs(p - ul)
                pred = left if pa <= pb and pa <= pc else (
                    b[i] if pb <= pc else ul)
                c[i] = (c[i] + pred) & 255
            cur = np.asarray(c, np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {f}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C]: C = 1 (grey), 2 (grey + alpha), 3
    (RGB, or a palette looked up) or 4 (RGBA). 8-bit, non-interlaced
    images only; other bit depths and Adam7 interlacing raise."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos, ihdr, idat, plte = 8, None, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth}: only 8-bit is read")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} unknown")
    if interlace:
        raise ValueError("interlaced PNGs are not read")
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError(f"PNG image data of {raw.size} bytes, expected "
                         f"{h * (w * ch + 1)}")
    img = _unfilter_rows(raw, h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        img = plte[img[..., 0]]
    return img


def read_png_rgb(path: str) -> np.ndarray:
    """A PNG file -> uint8 [H, W, 3], top row first, as PIL's
    convert("RGB") gives it: grey replicated, a palette looked up, alpha
    dropped."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.shape[2] <= 2:   # grey (+ alpha)
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3]


def load_texture(path: str, gamma: bool = True) -> np.ndarray:
    """LDR texture -> linear float32 [H, W, 3], V flipped so row 0 is the
    bottom (the reference's stbi flip + pow 2.2, imageio.cpp:11-44)."""
    arr = read_png_rgb(path).astype(np.float32) / 255.0
    arr = arr[::-1]
    if gamma:
        arr = arr ** 2.2
    return arr


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


def _read_cstr(buf: bytes, off: int) -> tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _predictor_decode(data: bytearray) -> bytes:
    """EXR 'deltas + interleave' post-zlib decode."""
    arr = np.frombuffer(bytes(data), np.uint8).astype(np.int32)
    arr = (np.cumsum(arr - 128, dtype=np.int64) % 256).astype(np.uint8)
    n = arr.shape[0]
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def load_exr(path: str) -> np.ndarray:
    """Scanline EXR -> float32 [H, W, 3] (RGB, or Y replicated; other
    channels dropped). HALF/FLOAT/UINT channels, NO/ZIPS/ZIP compression;
    tiled files and other compressions raise."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != 20000630:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR unsupported")
    off = 8
    channels = []   # (name, pixel type)
    compression = _COMP_NO
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if name == "":
            break
        _, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        val = buf[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while val[coff] != 0:
                cname, coff = _read_cstr(val, coff)
                (ptype,) = struct.unpack_from("<i", val, coff)
                coff += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", val)

    xmin, ymin, xmax, ymax = data_window
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    if compression not in (_COMP_NO, _COMP_ZIPS, _COMP_ZIP):
        raise ValueError(f"{path}: unsupported EXR compression {compression}")
    lines_per_block = {_COMP_NO: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}[compression]
    channels.sort(key=lambda c: c[0])   # stored alphabetically
    dtypes = {_PIX_HALF: np.float16, _PIX_FLOAT: np.float32,
              _PIX_UINT: np.uint32}
    ch_dtypes = [dtypes[t] for _, t in channels]
    bytes_per_pix = sum(np.dtype(d).itemsize for d in ch_dtypes)
    n_blocks = (height + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)

    planes = {name: np.zeros((height, width), np.float32)
              for name, _ in channels}
    line_bytes = width * bytes_per_pix
    for boff in offsets:
        y, dsize = struct.unpack_from("<iI", buf, boff)
        raw = buf[boff + 8:boff + 8 + dsize]
        y0 = y - ymin
        nlines = min(lines_per_block, height - y0)
        if compression != _COMP_NO and dsize < nlines * line_bytes:
            raw = _predictor_decode(bytearray(zlib.decompress(raw)))
        for li in range(nlines):
            line = raw[li * line_bytes:(li + 1) * line_bytes]
            coff = 0
            for (cname, _), dt in zip(channels, ch_dtypes):
                seg = np.frombuffer(line, dt, count=width, offset=coff)
                planes[cname][y0 + li] = seg.astype(np.float32)
                coff += width * np.dtype(dt).itemsize

    out = np.zeros((height, width, 3), np.float32)
    for i, c in enumerate("RGB"):
        if c in planes:
            out[..., i] = planes[c]
        elif "Y" in planes:
            out[..., i] = planes["Y"]
    return out


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
