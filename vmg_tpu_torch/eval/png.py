"""PNG read and write with zlib and numpy alone.

The machine with the card has neither cv2 nor PIL, so the evaluator
reads and writes its frames here.  Reads non-interlaced greyscale, grey
+ alpha, RGB and RGBA files at 8 or 16 bits a sample, with every row
filter (0-4); anything else (palette colour, interlacing, bit depths
below 8) raises and says what the file is.  Samples keep their depth, as
``cv2.IMREAD_UNCHANGED`` keeps them: uint8, or uint16 for a 16-bit file.
Writes 8- or 16-bit greyscale, RGB or RGBA with no row filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
_NAMES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind.decode('latin-1')} chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Rows of ``stride`` bytes, each after its filter-type byte, undone."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    cur[x] = (cur[x] + _paeth(a, b, c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W) for a greyscale file, else (H, W, channels), in the file's
    channel order (RGB, RGBA, grey + alpha); uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: {_NAMES.get(colour, f'colour type {colour}')} PNG; "
                         "only greyscale, grey + alpha, RGB and RGBA are read")
    if depth not in (8, 16):
        raise ValueError(f"{path}: {depth}-bit samples; only 8 and 16 are read")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG; only non-interlaced files are read")
    ch, nbytes = _CHANNELS[colour], depth // 8
    stride = width * ch * nbytes
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride, ch * nbytes, path)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(height, width, ch)
    return img[:, :, 0] if ch == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) greyscale or (H, W, 1 | 3 | 4) grey / RGB / RGBA
    samples, uint8 or uint16, as a PNG (zlib level 1: the frames are
    written once and read once)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        colour = 2 if img.shape[2] == 3 else 6
    else:
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    height, width = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img, dtype=">u2" if depth == 16 else np.uint8)
    rows = rows.reshape(height, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + _chunk(b"IEND", b""))
