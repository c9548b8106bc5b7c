"""Frame sequences and index windows (port of ``vmg_tpu/eval/eval_utils.py``,
the reference's ``utils/eval_utils.py``), on the zlib + numpy PNG reader
of :mod:`vmg_tpu_torch.eval.png` instead of cv2."""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from vmg_tpu_torch.eval.png import read_png


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) RGB, in its sample type (uint8, or uint16
    for a 16-bit PNG); greyscale repeats to three channels, alpha is
    dropped.  Raises for files other than PNG."""
    with open(path, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise ValueError(f"{path}: not a PNG file; the evaluator reads PNG frames")
    img = read_png(path)
    if img.ndim == 2:
        return img[:, :, None].repeat(3, 2)
    if img.shape[2] == 2:  # grey + alpha
        return img[:, :, :1].repeat(3, 2)
    return np.ascontiguousarray(img[:, :, :3])


def read_seq_images(path: str) -> np.ndarray:
    """A sorted frame sequence -> (N, H, W, 3) RGB."""
    paths = sorted(glob.glob(os.path.join(path, "*")))
    return np.stack([read_image(p) for p in paths], axis=0)


def index_generation(num_output_frames: int, num_GT: int) -> List[List[int]]:
    """Overlapping index windows covering num_GT frames."""
    indices_list = []
    right = num_output_frames
    while right <= num_GT:
        indices_list.append(list(range(right - num_output_frames, right)))
        right += num_output_frames - 1
    if right - num_output_frames < num_GT - 1:
        indices_list.append(list(range(num_GT - num_output_frames, num_GT)))
    return indices_list
