"""Minimal PNG writer (lodepng replacement, reference CGL/include/CGL/lodepng.h).

Pure-python RGBA8 encoder: IHDR + zlib-compressed scanlines (filter 0) +
IEND. Only what the renderer needs — encode; decoding is not used by the
headless pipeline.

The port's copy of `rrt_tpu/io/png.py`.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str, rgba: np.ndarray):
    """Write an (H, W, 4) uint8 array as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(rgba))


def encode_png(rgba: np.ndarray) -> bytes:
    """The PNG file's bytes of an (H, W, 4) (or (H, W, 3)) uint8 array."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w = rgba.shape[:2]
    if rgba.shape[2] == 3:
        rgba = np.concatenate(
            [rgba, np.full((h, w, 1), 255, np.uint8)], axis=2)
    raw = b"".join(
        b"\x00" + rgba[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw, 6))
    out += _chunk(b"IEND", b"")
    return out


def read_png(path: str) -> np.ndarray:
    """Tiny PNG reader for round-trip/parity tests: RGB/RGBA/palette/gray
    (8-bit, plus 1/2/4-bit gray & palette — lodepng auto-picks the smallest
    encoding, e.g. 1-bit gray for an all-black frame), filters 0-4."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    color_type = None
    palette = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", payload[:10])
            assert color_type in (0, 2, 3, 4, 6)
            assert depth == 8 or (depth in (1, 2, 4)
                                  and color_type in (0, 3))
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    if depth < 8:
        # sub-byte gray/palette: unfilter byte-wise (bpp=1), then unpack
        stride_b = (w * depth + 7) // 8
        img_b = np.zeros((h, stride_b), np.uint8)
        prev = np.zeros(stride_b, np.int32)
        pos = 0
        for y in range(h):
            f = raw[pos]
            line = np.frombuffer(
                raw[pos + 1:pos + 1 + stride_b], np.uint8).astype(np.int32)
            pos += 1 + stride_b
            if f == 0:
                out = line
            elif f == 2:
                out = (line + prev) & 0xFF
            else:
                out = np.zeros(stride_b, np.int32)
                for i in range(stride_b):
                    a = out[i - 1] if i >= 1 else 0
                    b = prev[i]
                    c = prev[i - 1] if i >= 1 else 0
                    if f == 1:
                        pred = a
                    elif f == 3:
                        pred = (a + b) // 2
                    else:
                        p = a + b - c
                        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                        pred = a if pa <= pb and pa <= pc else (
                            b if pb <= pc else c)
                    out[i] = (line[i] + pred) & 0xFF
            img_b[y] = out.astype(np.uint8)
            prev = out
        bits = np.unpackbits(img_b, axis=1)
        vals = bits.reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint16)
        px = (vals * weights).sum(-1)[:, :w].astype(np.uint8)
        if color_type == 3:
            img = palette[px]
        else:
            scale = 255 // ((1 << depth) - 1)
            img = np.repeat((px * scale)[..., None].astype(np.uint8),
                            3, axis=2)
        return img
    stride = w * nch
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        f = raw[pos]
        line = np.frombuffer(
            raw[pos + 1:pos + 1 + stride], np.uint8).astype(np.int32)
        pos += 1 + stride
        out = np.zeros(stride, np.int32)
        if f == 0:
            out = line
        elif f == 2:
            out = (line + prev) & 0xFF
        else:
            for i in range(stride):
                a = out[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) // 2
                else:  # paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                out[i] = (line[i] + pred) & 0xFF
        img[y] = out.astype(np.uint8)
        prev = out
    img = img.reshape(h, w, nch)
    if color_type == 3:
        img = palette[img[..., 0]]
    elif color_type == 0:
        img = np.repeat(img, 3, axis=2)
    elif color_type == 4:
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=2),
                              img[..., 1:]], axis=2)
    return img
