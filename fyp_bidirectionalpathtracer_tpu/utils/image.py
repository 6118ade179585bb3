"""Image IO + quality metrics (PNG write, PSNR) — the test-harness analogue
of Falcor's screenshot capture + ImageMagick compare (RunTestsSet.py:262-289).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def to_u8(img) -> np.ndarray:
    arr = np.asarray(img)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """8-bit RGB PNG of a [H, W, 3|4] float image in [0, 1] (alpha dropped),
    written with zlib alone: filter type 0 on every row."""
    u8 = to_u8(img)
    h, w = u8.shape[:2]
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))
    with open(path, "wb") as fh:
        fh.write(_PNG_MAGIC)
        fh.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fh.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(_png_chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) -> [h, w * bpp] uint8."""
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            # sequential in x: each byte depends on the decoded byte bpp left
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png_u8(path: str) -> np.ndarray:
    """8-bit RGB or RGBA, non-interlaced PNG -> [H, W, 3|4] uint8."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are supported "
            f"(bit depth {depth}, color type {ctype}, interlace {interlace})")
    bpp = 3 if ctype == 2 else 4
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    return pix.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """PNG -> [H, W, 3] float32 RGB in [0, 1] (alpha dropped)."""
    return read_png_u8(path)[..., :3].astype(np.float32) / 255.0


def read_image_rgba(path: str) -> np.ndarray:
    """Any image -> [h, w, 4] float32 rgba as stored: .hdr through the RGBE
    reader (linear radiance), .png through the decoder above, anything else
    (JPG, ...) through PIL, which is then required."""
    lower = path.lower()
    if lower.endswith(".hdr"):
        return read_hdr(path)
    if lower.endswith(".png"):
        u8 = read_png_u8(path)
        if u8.shape[-1] == 3:
            u8 = np.concatenate([u8, np.full_like(u8[..., :1], 255)], -1)
        return u8.astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"reading {path!r} needs Pillow (PIL); PNG and .hdr images are "
            "read without it") from exc
    return np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0


def mse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape[-1] == 4:
        a = a[..., :3]
    if b.shape[-1] == 4:
        b = b[..., :3]
    return float(np.mean((a - b) ** 2))


def psnr(a, b, peak: float = 1.0) -> float:
    m = mse(a, b)
    if m <= 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


def read_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader -> [h, w, 4] float32 (a=1).

    Handles the 32-bit_rle_rgbe format: new-style RLE scanlines (0x02 0x02
    length marker, per-component runs) and flat scanlines.  Decode follows
    Radiance's ldexp((c + 0.5) / 256, e - 128).
    """
    with open(path, "rb") as fh:
        if not fh.readline().startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance file")
        while True:
            line = fh.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = fh.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"{path}: unsupported resolution line {dims}")
        h, w = int(dims[1]), int(dims[3])
        data = fh.read()

    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2 \
                and (data[pos + 2] << 8 | data[pos + 3]) == w:
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            data, np.uint8, count, pos)
                        pos += count
                        x += count
        else:  # flat scanline
            row = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            rgbe[y] = row
            pos += w * 4

    mant = rgbe[..., :3].astype(np.float32) + 0.5
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0 / 256.0, e - 128)).astype(np.float32)
    rgb = mant * scale[..., None]
    rgb[rgbe[..., 3] == 0] = 0.0
    return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)


def write_hdr(path: str, img) -> None:
    """Minimal Radiance RGBE writer (flat scanlines) for fixtures/tests."""
    rgb = np.asarray(img, np.float32)[..., :3]
    h, w = rgb.shape[:2]
    m = rgb.max(-1)
    e = np.zeros((h, w), np.int32)
    nz = m > 1e-32
    e[nz] = np.frexp(m[nz])[1]
    scale = np.zeros((h, w), np.float32)
    scale[nz] = np.ldexp(256.0, -e[nz])
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        fh.write(f"-Y {h} +X {w}\n".encode())
        fh.write(rgbe.tobytes())


def read_image(path: str) -> np.ndarray:
    """Env-map image -> [h, w, 4] float32 rgba with alpha 1: .hdr as linear
    radiance, everything else as [0,1] sRGB-as-stored (the reference samples
    its PNG/JPG probes without conversion, lightProbeGBuffer.rt.hlsl:64-75)."""
    img = read_image_rgba(path)
    if not path.lower().endswith(".hdr"):
        img[..., 3] = 1.0
    return img
