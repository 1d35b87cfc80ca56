"""Minimal OpenEXR scanline I/O for the `-e` flag (the port's own copy of
`rrt_tpu/io/exr.py`; the reference reads with tinyexr, main.cpp:42-79).

Supports the subset HDR environment maps actually use: single-part
scanline files, HALF or FLOAT channels, NONE or ZIP(S) compression,
R/G/B(/A) channels. Writes uncompressed FLOAT files for round-tripping.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630


def _read_null_str(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin1"), end + 1


def _read_attrs(buf, pos):
    attrs = {}
    while buf[pos] != 0:
        name, pos = _read_null_str(buf, pos)
        typ, pos = _read_null_str(buf, pos)
        (size,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos:pos + size])
        pos += size
    return attrs, pos + 1


def _parse_channels(data):
    chans = []
    pos = 0
    while data[pos] != 0:
        name, pos = _read_null_str(data, pos)
        # layout: pixel_type(4) pLinear(1) reserved(3) xSampling(4) ySampling(4)
        (ptype,) = struct.unpack_from("<I", data, pos)
        pos += 16
        chans.append((name, ptype))
    return chans


def read_exr(path: str) -> np.ndarray:
    """Read an EXR file → (H, W, 3) float32 RGB."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    attrs, pos = _read_attrs(buf, 8)

    chans = _parse_channels(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3):  # NONE, ZIPS, ZIP
        raise ValueError(f"unsupported EXR compression {comp}")
    dx0, dy0, dx1, dy1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w = dx1 - dx0 + 1
    h = dy1 - dy0 + 1

    lines_per_block = 1 if comp in (0, 2) else 16
    n_blocks = -(-h // lines_per_block)

    # scanline offset table
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)
    pos += 8 * n_blocks

    dtype = {1: np.float16, 2: np.float32}  # HALF, FLOAT
    chan_names = [c[0] for c in chans]       # alphabetical per spec
    out = {c: np.zeros((h, w), np.float32) for c in chan_names}

    for off in offsets:
        y, size = struct.unpack_from("<iI", buf, off)
        data = buf[off + 8:off + 8 + size]
        if comp in (2, 3):
            data = zlib.decompress(data)
            # EXR zip post-processing: delta-predictor then de-interleave
            # (t[i] = t[i-1] + stored[i] - 128; halves interleave to bytes)
            d = np.frombuffer(data, np.uint8).astype(np.int64)
            d = np.concatenate([d[:1], d[1:] - 128])
            arr = np.cumsum(d).astype(np.uint8)
            half = (len(arr) + 1) // 2
            inter = np.zeros(len(arr), np.uint8)
            inter[0::2] = arr[:half]
            inter[1::2] = arr[half:]
            data = inter.tobytes()
        row0 = y - dy0
        n_rows = min(lines_per_block, h - row0)
        p = 0
        for r in range(n_rows):
            for cname, ptype in chans:
                nbytes = w * (2 if ptype == 1 else 4)
                row = np.frombuffer(
                    data[p:p + nbytes], dtype[ptype]).astype(np.float32)
                out[cname][row0 + r] = row
                p += nbytes

    rgb = np.stack([
        out.get("R", np.zeros((h, w), np.float32)),
        out.get("G", np.zeros((h, w), np.float32)),
        out.get("B", np.zeros((h, w), np.float32)),
    ], axis=-1)
    return rgb


def write_exr(path: str, rgb: np.ndarray):
    """Write (H, W, 3) float32 as an uncompressed FLOAT scanline EXR."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]

    def attr(name, typ, payload):
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<I", len(payload)) + payload)

    chan = b""
    for c in ("B", "G", "R"):  # alphabetical
        chan += c.encode() + b"\x00" + struct.pack("<I12x", 2)
    chan += b"\x00"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += attr("channels", "chlist", chan)
    header += attr("compression", "compression", b"\x00")
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    head = struct.pack("<ii", _MAGIC, 2) + header
    table_pos = len(head)
    data_start = table_pos + 8 * h

    line_size = 8 + 3 * 4 * w
    offsets = [data_start + i * line_size for i in range(h)]

    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<iI", y, 3 * 4 * w))
            # channels alphabetical: B, G, R
            f.write(rgb[y, :, 2].tobytes())
            f.write(rgb[y, :, 1].tobytes())
            f.write(rgb[y, :, 0].tobytes())
