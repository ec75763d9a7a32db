"""8-bit PNG with the standard library (zlib, struct) and numpy: what the
data layer needs of PIL where PIL is not installed.

`write_png` writes 8-bit grey (or RGB) with filter 0 on every row; the
pixels are what is compared, so compression level 1 is enough.
`read_gray` reads non-interlaced 8-bit grey, grey+alpha, RGB, RGBA and
palette files (grey and palette also at 1, 2 and 4 bits) with all five row
filters, and returns f32 grey levels as the native loader
(csrc/frame_loader.cc) and PIL's `convert("L")` give them: alpha and tRNS
are dropped, colour goes through PIL's integer luma
`(R*19595 + G*38470 + B*7471 + 0x8000) >> 16`. 16-bit and interlaced files
are declined with an IOError, as the native loader declines them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write an (H, W) grey or (H, W, 3) RGB uint8 image."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"want (H, W) or (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    data = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _chunks(blob: bytes, path: str):
    if blob[:8] != _SIGNATURE:
        raise IOError(f"not a PNG file: {path}")
    pos = 8
    while pos + 8 <= len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        yield kind, blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise IOError(f"truncated PNG file: {path}")


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """(h, stride) uint8 scanlines from the filtered stream."""
    if len(raw) < h * (stride + 1):
        raise IOError(f"PNG image data too short: {path}")
    buf = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    kinds = buf[:, 0]
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        line = buf[y, 1:]
        kind = int(kinds[y])
        if kind == 0:  # None
            cur = line
        elif kind == 1:  # Sub: a running sum, sample by sample
            cur = np.empty(stride, np.uint8)
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(line[k::bpp], dtype=np.uint64).astype(np.uint8)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            cur_b = bytearray(line.tobytes())
            prior_b = prior.tobytes()
            if kind == 3:
                for i in range(stride):
                    left = cur_b[i - bpp] if i >= bpp else 0
                    cur_b[i] = (cur_b[i] + ((left + prior_b[i]) >> 1)) & 0xFF
            else:
                _paeth_row(cur_b, prior_b, bpp)
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise IOError(f"PNG row filter {kind} unknown: {path}")
        out[y] = cur
        prior = out[y]
    return out


def _unpack(lines: np.ndarray, depth: int, w: int) -> np.ndarray:
    """(h, stride) packed 1/2/4-bit samples -> (h, w) values, MSB first."""
    bits = np.unpackbits(lines, axis=1)  # (h, stride * 8)
    per = 8 // depth
    bits = bits[:, : lines.shape[1] * 8].reshape(lines.shape[0], lines.shape[1] * per, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2).astype(np.uint8)[:, :w]


def _luma(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.float32)


def read_gray(path: str) -> np.ndarray:
    """Decode a PNG to (h, w) f32 grey levels in [0, 255]."""
    with open(path, "rb") as f:
        blob = f.read()
    header, palette, idat = None, None, []
    for kind, data in _chunks(blob, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise IOError(f"PNG without IHDR: {path}")
    w, h, depth, color, _, _, interlace = header
    if depth == 16:
        raise IOError(f"16-bit PNG declined: {path}")
    if interlace:
        raise IOError(f"interlaced PNG declined: {path}")
    if color not in _CHANNELS or (depth != 8 and color not in (0, 3)):
        raise IOError(f"PNG colour type {color} at {depth} bits not supported: {path}")
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    stride = (w * ch * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise IOError(f"PNG image data corrupt: {path} ({exc})") from None
    lines = _unfilter(raw, h, stride, bpp, path)
    if depth < 8:
        vals = _unpack(lines, depth, w)
        if color == 0:  # scale to 8 bits: 1 -> 255, 3 (2-bit) -> 255, ...
            vals = (vals.astype(np.uint32) * (255 // ((1 << depth) - 1))).astype(np.uint8)
    else:
        vals = lines.reshape(h, w, ch) if ch > 1 else lines
    if color == 0:
        return vals.astype(np.float32)
    if color == 4:
        return vals[..., 0].astype(np.float32)
    if color == 3:
        if palette is None:
            raise IOError(f"palette PNG without PLTE: {path}")
        if int(vals.max(initial=0)) >= len(palette):
            raise IOError(f"palette index out of range: {path}")
        return _luma(palette[vals])
    return _luma(vals[..., :3])
