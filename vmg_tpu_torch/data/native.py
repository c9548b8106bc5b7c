"""The native clip assembly (``vmg_tpu/data/native.py``): gather, crop,
flip / rotate and uint8 -> float32 of packed frames in one C++ pass
(``native/packbatch.cpp``, OpenMP over frames or clips), through ctypes.

The port builds its own copy of the library under ``vmg_tpu_torch/_build/``
(:func:`vmg_tpu_torch._build.load_packbatch`) and has no fallback: where
the library does not build or load, these functions raise.  The calls
release the GIL, so the loader's worker threads assemble in parallel.
:func:`assemble_clip_numpy` is the plain version, bit for bit
(``px / 255.0f`` in float32 on both sides).
"""

from __future__ import annotations

import numpy as np

from vmg_tpu_torch._build import load_packbatch

# assemble_batch() calls: the packed training path counts them
calls = 0


def _base(mm: np.ndarray) -> int:
    return mm.ctypes.data


def assemble_clip(mm: np.ndarray, frame_shape, frame_indices, cy: int, cx: int,
                  ch: int, cw: int, hflip: bool, vflip: bool, rot90: bool) -> np.ndarray:
    """(T, ch, cw, C) float32, or (T, cw, ch, C) with ``rot90``: frames
    ``frame_indices`` of the packed array ``mm``, cropped at (cy, cx),
    flipped, then transposed."""
    H, W, C = frame_shape
    idx = np.ascontiguousarray(np.asarray(frame_indices, np.int64))
    out_h, out_w = (cw, ch) if rot90 else (ch, cw)
    out = np.empty((len(idx), out_h, out_w, C), np.float32)
    rc = load_packbatch().assemble_clip(_base(mm), H, W, C, idx.ctypes.data, len(idx),
                                        cy, cx, ch, cw, int(hflip), int(vflip), int(rot90),
                                        out.ctypes.data)
    if rc != 0:
        raise ValueError("assemble_clip: crop out of bounds")
    return out


def assemble_batch(mm: np.ndarray, frame_shape, frame_indices: np.ndarray,
                   crops: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """B clips in one call (OpenMP over clips): (B, T, ch, cw, C) float32.
    ``frame_indices``: (B, T) int64; ``crops``: (B, 4) int64 rows of (cy,
    cx, hflip | vflip << 1 | rot90 << 2, 0).  Square crops only (``ch ==
    cw``), so rot90 keeps the shape."""
    global calls
    if ch != cw:
        raise ValueError("assemble_batch takes square crops")
    H, W, C = frame_shape
    idx = np.ascontiguousarray(np.asarray(frame_indices, np.int64))
    cr = np.ascontiguousarray(np.asarray(crops, np.int64))
    B, T = idx.shape
    if cr.shape != (B, 4):
        raise ValueError(f"crops must be ({B}, 4), got {cr.shape}")
    out = np.empty((B, T, ch, cw, C), np.float32)
    rc = load_packbatch().assemble_batch(_base(mm), H, W, C, idx.ctypes.data, B, T,
                                         cr.ctypes.data, ch, cw, out.ctypes.data)
    if rc != 0:
        raise ValueError("assemble_batch: crop out of bounds")
    calls += 1
    return out


def assemble_clip_numpy(mm: np.ndarray, frame_shape, frame_indices, cy: int, cx: int,
                        ch: int, cw: int, hflip: bool, vflip: bool, rot90: bool
                        ) -> np.ndarray:
    """The plain version of :func:`assemble_clip`."""
    n = int(np.prod(frame_shape))
    frames = np.stack([mm[i * n: (i + 1) * n].reshape(frame_shape)
                       for i in frame_indices])[:, cy: cy + ch, cx: cx + cw]
    if hflip:
        frames = frames[:, :, ::-1]
    if vflip:
        frames = frames[:, ::-1]
    if rot90:
        frames = frames.transpose(0, 2, 1, 3)
    return frames.astype(np.float32) / np.float32(255.0)
