"""MATLAB-compatible colour conversions (``vmg_tpu/data/color.py``), without
cv2.

uint8 inputs round to uint8 outputs; float inputs in [0, 1] return floats
in [0, 1].  ``channel_convert``'s BGR -> gray is ``cv2.cvtColor``'s
fixed-point formula on uint8 (Y = (B 3735 + G 19235 + R 9798 + 2^14) >> 15),
and its float formula on float images.
"""

from __future__ import annotations

import numpy as np


def _convert(img: np.ndarray, matrix, offset):
    in_type = img.dtype
    x = img.astype(np.float32)
    if in_type != np.uint8:
        x = x * 255.0
    out = x @ np.asarray(matrix, np.float32) / 255.0 + np.asarray(offset, np.float32)
    if in_type == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    if only_y:
        return _convert(img, np.asarray([[65.481], [128.553], [24.966]]), [16.0])[..., 0]
    return _convert(img, [[65.481, -37.797, 112.0],
                          [128.553, -74.203, -93.786],
                          [24.966, 112.0, -18.214]], [16.0, 128.0, 128.0])


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    return rgb2ycbcr(img[..., ::-1], only_y)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    in_type = img.dtype
    x = img.astype(np.float32)
    if in_type != np.uint8:
        x = x * 255.0
    mat = np.asarray([[0.00456621, 0.00456621, 0.00456621],
                      [0.0, -0.00153632, 0.00791071],
                      [0.00625893, -0.00318811, 0.0]], np.float32)
    out = x @ mat * 255.0 + np.asarray([-222.921, 135.576, -276.836], np.float32)
    if in_type == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(in_type)


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` of an (H, W, 3) image."""
    if img.dtype == np.uint8:
        b, g, r = (img[..., i].astype(np.int32) for i in range(3))
        return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)
    x = img.astype(np.float32)
    out = (x[..., 0] * np.float32(0.114) + x[..., 1] * np.float32(0.587)
           + x[..., 2] * np.float32(0.299))
    return out.astype(img.dtype)


def channel_convert(in_c: int, tar_type: str, img_list):
    """BGR <-> gray / y conversions over a list (reference data/util.py:4)."""
    if in_c == 3 and tar_type == "gray":
        return [np.expand_dims(bgr2gray(im), 2) for im in img_list]
    if in_c == 3 and tar_type == "y":
        return [np.expand_dims(bgr2ycbcr(im, only_y=True), 2) for im in img_list]
    if in_c == 1 and tar_type == "RGB":
        return [np.repeat(im if im.ndim == 3 else im[..., None], 3, axis=2)
                for im in img_list]
    return img_list
