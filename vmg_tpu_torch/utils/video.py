"""Video export and a terminal progress bar (``vmg_tpu/utils/video.py``;
the reference's ``utils/make_video.py`` and ``utils/progress_bar.py``)."""

from __future__ import annotations

import glob
import os
import sys
import time


def make_video(png_dir: str, out_path: str, fps: int = 25) -> str:
    """A directory of PNGs (in name order) -> an MP4 at ``out_path``,
    through cv2's writer.  Where cv2 is missing (the card's machine has
    none) this is refused by name: the port writes no video codec."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("make_video writes MP4 through OpenCV (cv2), which is not "
                           "installed here; the port has no video encoder of its own") from e
    paths = sorted(glob.glob(os.path.join(png_dir, "*.png")))
    if not paths:
        raise FileNotFoundError(f"no PNGs under {png_dir}")
    h, w = cv2.imread(paths[0]).shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for p in paths:
        writer.write(cv2.imread(p))
    writer.release()
    return out_path


class ProgressBar:
    """A terminal progress bar with its ETA."""

    def __init__(self, total: int, width: int = 40, stream=None):
        self.total, self.width, self.count = total, width, 0
        self.stream = stream or sys.stdout
        self.start = time.time()

    def update(self, msg: str = "") -> None:
        self.count += 1
        frac = self.count / self.total
        filled = int(self.width * frac)
        elapsed = time.time() - self.start
        eta = elapsed / max(frac, 1e-9) * (1 - frac)
        bar = "#" * filled + "-" * (self.width - filled)
        self.stream.write(f"\r[{bar}] {self.count}/{self.total} eta {eta:5.0f}s {msg}")
        if self.count >= self.total:
            self.stream.write("\n")
        self.stream.flush()
